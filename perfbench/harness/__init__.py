"""The benchmark's machinery: definitions (:mod:`.spec`), weights from the
seed (:mod:`.weights`), traffic (:mod:`.traffic`), the system under test
(:mod:`.system`), the load drivers (:mod:`.drive`), the device trace
(:mod:`.trace`), the correctness check (:mod:`.check`) and the run
(:mod:`.cli`)."""
