"""In-memory log ring buffer for the operator UI (a copy of
``genie_tts_tpu/utils/logs.py`` for the port's package logger).

Role of the reference GUI's log tab (``GUI/GUI.py:39-54,625-626``, which
redirects stdout into a Qt pane): a logging.Handler keeping the last N
records, served at ``GET /logs``.
"""
from __future__ import annotations

import logging
import threading
from collections import deque
from typing import List

_FMT = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s",
                         datefmt="%H:%M:%S")


class RingLogHandler(logging.Handler):
    def __init__(self, capacity: int = 500):
        super().__init__()
        self._lock2 = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self.setFormatter(_FMT)

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
        except Exception:  # pragma: no cover - formatter edge cases
            return
        with self._lock2:
            self._buf.append(line)

    def snapshot(self) -> List[str]:
        with self._lock2:
            return list(self._buf)


_handler: RingLogHandler = None


def install(capacity: int = 500) -> RingLogHandler:
    """Attach the ring handler to the package logger (idempotent)."""
    global _handler
    if _handler is None:
        _handler = RingLogHandler(capacity)
        logging.getLogger("genie_tts_tpu_torch").addHandler(_handler)
        logging.getLogger("genie_tts_tpu_torch").setLevel(logging.INFO)
    return _handler


def snapshot() -> List[str]:
    return _handler.snapshot() if _handler else []
