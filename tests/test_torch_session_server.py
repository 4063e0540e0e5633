"""The port's HTTP server, sessions and CLI on the CPU.

A tiny character (tests/test_torch_pair.py) served by ``api.start_server(...,
port=0, device="cpu")`` in-process, small slot and stream geometries:

* GET ``/health``, ``/``, ``/metrics``; an unknown endpoint is 404 and a
  malformed JSON body 400; ``/tts`` for a character with no reference
  clip is an error;
* ``/tts`` of a sentence the slot machine serves returns exactly the
  bytes of the int16 waveform the same synth function gives (greedy, so
  both runs decode the same codes; the finisher's noise is seeded): no
  second float conversion (ROADMAP.md, Queue 3);
* a sentence too long for the slot buckets is served by the window
  batcher; ``"stream": true`` streams (2 * codes * hop samples);
* ``tts(save_path=...)`` runs through the session and writes what it
  returns; concurrent ``tts`` calls each get their own audio, and a
  failed sentence raises from ``tts``; ``tts_async`` yields PCM16; ``stop()`` ends a session early;
  ``play=True`` without sounddevice logs a warning and still synthesizes;
* ``/set_reference_audio`` with ``"warmup": true`` sweeps the character;
* ``serve --device cpu --warmup DIR`` runs the warmup sweep (on the CPU
  the decode programs run eagerly, no graph is captured), then answers
  ``/health`` from the CLI, and ``serve``
  with no device named stops when there is no GPU.

Every request, join and queue read has a timeout.
"""
import asyncio
import json
import os
import queue
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from genie_tts_tpu_torch import api
from genie_tts_tpu_torch.config import RuntimeConfig
from genie_tts_tpu_torch.ops.sampling import SamplingConfig
from genie_tts_tpu_torch.runtime.engine import TTSEngine
from genie_tts_tpu_torch.utils.wavio import read_audio

from test_torch_pair import HOP, write_character

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 120
SHORT = "きょうはいいてんきですね"
LONG = ("きょうはとてもいいてんきなので、ともだちといっしょにこうえんへいって、"
        "ながいあいださんぽをしてから、えきのちかくのきっさでこーひーをのみました")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    char_dir, hub, ref = write_character(root)
    eng = TTSEngine(RuntimeConfig(
        phoneme_buckets=(32, 64, 128), prompt_buckets=(32, 128),
        frame_buckets=(32, 64), slot_batch=2, slot_steps=8,
        slot_phoneme_bucket=64, slot_prompt_bucket=128, batch_window_ms=1.0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GENIE_HUBERT_DIR", str(hub))
        mp.setattr(api, "engine", eng)
        mp.setattr(api, "_batcher", None)
        srv = api.start_server(host="127.0.0.1", port=0, block=False, device="cpu")
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            _post(base, "/load_character", {"character_name": "srv", "model_dir": str(char_dir),
                                            "language": "ja"}).read()
            _post(base, "/set_reference_audio", {
                "character_name": "srv", "audio_path": str(ref),
                "audio_text": "こんにちは、てすとです", "language": "ja"}).read()
            yield base, char_dir, ref, root
        finally:
            srv.shutdown()
            srv.server_close()
            for name in ("srv", "noref"):
                api.unload_character(name)
            if api._batcher is not None:
                api._batcher.stop()
            api._reference_audios.pop("srv", None)


def _post(base, path, payload, raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=TIMEOUT)


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=TIMEOUT)


def test_get_endpoints_and_errors(served):
    base = served[0]
    assert json.loads(_get(base, "/health").read()) == {"status": "ok"}
    assert b"genie-tts-tpu-torch" in _get(base, "/").read()
    assert "counters" in json.loads(_get(base, "/metrics").read())
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base, "/nope")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/tts", None, raw=b"{not json")
    assert e.value.code == 400


def test_tts_before_reference_is_an_error(served):
    base, char_dir, _, _ = served
    _post(base, "/load_character", {"character_name": "noref", "model_dir": str(char_dir),
                                    "language": "ja"}).read()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/tts", {"character_name": "noref", "text": SHORT})
    assert e.value.code == 500
    assert b"set_reference_audio" in e.value.read()


def test_set_reference_audio_with_warmup_sweeps(served):
    """``"warmup": true`` runs the character's warmup sweep: its decode
    graphs' keys exist before its first request, which then finds them."""
    from genie_tts_tpu_torch.runtime import graphs

    base, char_dir, ref, _ = served
    _post(base, "/load_character", {"character_name": "warm", "model_dir": str(char_dir),
                                    "language": "ja"}).read()
    try:
        _post(base, "/set_reference_audio", {
            "character_name": "warm", "audio_path": str(ref),
            "audio_text": "こんにちは、てすとです", "language": "ja", "warmup": True}).read()
        cache = graphs.cache_for(api.model_manager.get("warm").t2s_params)
        assert any(k[0] == "generate" for k in cache.keys())
        assert cache.stats["variants"] > 0
        cache.reset_stats()
        _post(base, "/tts", {"character_name": "warm", "text": SHORT,
                             "split_sentence": False}).read()
        assert cache.stats["misses"] == 0 and cache.stats["hits"] > 0
    finally:
        api.unload_character("warm")
        api._reference_audios.pop("warm", None)


def test_tts_bytes_are_the_int16_waveform(served):
    base = served[0]
    body = _post(base, "/tts", {"character_name": "srv", "text": SHORT,
                                "split_sentence": False, "top_k": 1}).read()
    synth, _ = api._make_synth_fn("srv", sampling=SamplingConfig(top_k=1),
                                  use_batcher=True)
    audio = synth(SHORT)
    sb = api._slot_batchers["srv"]
    assert audio.dtype == np.int16 and sb.stats["segments"] > 0
    assert len(audio) > 0 and len(audio) % (2 * HOP) == 0
    assert body == audio.astype("<i2").tobytes()
    pcm = np.frombuffer(body, "<i2")
    assert len(np.unique(pcm)) > 100, "PCM collapsed to a few levels"


def test_long_sentence_takes_the_window_batcher(served):
    base = served[0]
    body = _post(base, "/tts", {"character_name": "srv", "text": LONG,
                                "split_sentence": False}).read()
    assert api._batcher is not None and api._batcher.stats["rows"] >= 1
    assert len(body) > 0 and len(body) % (2 * 2 * HOP) == 0


def test_stream_flag_streams(served):
    base = served[0]
    segs = api._slot_batchers["srv"].stats["segments"]
    body = _post(base, "/tts", {"character_name": "srv", "text": SHORT,
                                "split_sentence": False, "stream": True}).read()
    assert len(body) > 0 and len(body) % (2 * 2 * HOP) == 0
    # the slot machine was idle: the solo segmented stream served it
    assert api._slot_batchers["srv"].stats["segments"] == segs


def test_tts_save_path_through_the_session(served, tmp_path):
    out = tmp_path / "out.wav"
    audio = api.tts("srv", SHORT + "。" + SHORT + "。", save_path=out)
    wav, sr = read_audio(out)
    assert sr == 32000 and audio.dtype == np.float32
    assert len(wav) == len(audio) > 0 and len(audio) % (2 * HOP) == 0
    np.testing.assert_allclose(wav, np.clip(audio, -1, 1), atol=2.0 / 32767)


def test_concurrent_tts_calls_keep_their_own_audio(served):
    """Two threads call ``tts`` at once with sentences of different
    lengths: each gets its own sentence's audio (greedy, so the lengths of
    a call alone are the reference)."""
    greedy = SamplingConfig(top_k=1)
    texts = [SHORT + "。", LONG + "。"]
    alone = [len(api.tts("srv", t, sampling=greedy)) for t in texts]
    assert alone[0] != alone[1]
    got, errors = {}, []

    def call(i):
        try:
            got[i] = api.tts("srv", texts[i], sampling=greedy)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not errors and not any(t.is_alive() for t in threads)
    assert [len(got[i]) for i in range(2)] == alone


def test_tts_raises_a_failed_sentence(served, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("injected synthesis fault")

    monkeypatch.setattr(api.engine, "synthesize_utterance", boom)
    with pytest.raises(RuntimeError, match="injected synthesis fault"):
        api.tts("srv", SHORT + "。")


def test_tts_async_yields_pcm16(served):
    async def collect():
        return [c async for c in api.tts_async("srv", SHORT + "。")]

    chunks = asyncio.run(asyncio.wait_for(collect(), TIMEOUT))
    assert chunks and sum(len(c) for c in chunks) % (2 * 2 * HOP) == 0


def test_stop_ends_a_session(served):
    from genie_tts_tpu_torch.runtime.session import session_registry

    done = []

    def slow(sentence):
        time.sleep(0.05)
        done.append(sentence)
        return np.zeros(HOP, np.float32)

    s = session_registry.create()
    s.start_session(slow, split=False)
    for i in range(100):
        s.feed(f"s{i}")
    s.end_session()
    time.sleep(0.2)
    api.stop()
    assert s._tts_done.wait(TIMEOUT)
    time.sleep(0.2)
    assert 0 < len(done) < 100


def test_cli_serve_on_cpu(served):
    _, char_dir, _, _ = served
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "genie_tts_tpu_torch", "serve", "--device", "cpu",
         "--port", "0", "--warmup", str(char_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        port = None
        deadline = time.monotonic() + TIMEOUT
        seen = []
        while port is None and time.monotonic() < deadline:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                continue
            seen.append(line)
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1])
        assert port is not None, "the server never started:\n" + "".join(seen)
        assert any("warmup: captured" in x for x in seen), "".join(seen)
        assert json.loads(_get(f"http://127.0.0.1:{port}", "/health").read())["status"] == "ok"
    finally:
        proc.terminate()
        proc.wait(timeout=TIMEOUT)


def test_cli_serve_without_device_raises_without_gpu(monkeypatch):
    from genie_tts_tpu_torch import __main__ as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--port", "0"])


def test_play_without_sounddevice_warns(served, caplog, monkeypatch):
    from genie_tts_tpu_torch.runtime import session

    monkeypatch.setattr(session, "_HAS_AUDIO_OUT", False)
    with caplog.at_level("WARNING", logger=session.__name__):
        audio = api.tts("srv", SHORT + "。", play=True)
    assert len(audio) > 0
    assert any("play=True ignored" in r.message for r in caplog.records)
    api.wait_for_playback_done()
