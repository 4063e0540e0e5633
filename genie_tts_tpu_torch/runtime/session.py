"""Streaming session engine: sentence-pipelined synthesis + playback.

A copy of ``genie_tts_tpu/runtime/session.py``: a TTS worker thread and a
playback worker thread joined by queues, sentence-granular streaming
(sentence i plays while i+1 synthesizes), per-session save-to-wav, a chunk
callback for HTTP streaming, stop semantics and completion events.

Two changes: a chunk goes to the callback as PCM16 bytes with int16
pieces sent as they are (``utils/wavio.py::pcm16_bytes``; the reference's
session converts them a second time), and the TTS worker runs in
``torch.inference_mode``, which is per thread. Playback uses sounddevice
when importable; otherwise ``play=True`` logs a warning and is ignored.
"""
from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from ..frontend.splitter import split_text
from ..utils.wavio import as_float, pcm16_bytes, write_wav

logger = logging.getLogger(__name__)

SAMPLE_RATE = 32000
_STREAM_END = object()
_AUDIO_END = object()

try:
    import sounddevice  # type: ignore

    _HAS_AUDIO_OUT = True
except Exception:  # pragma: no cover
    sounddevice = None
    _HAS_AUDIO_OUT = False


class TTSSession:
    """Serializes synthesis requests; owns worker threads."""

    def __init__(self):
        self._api_lock = threading.Lock()
        self._text_q: "queue.Queue" = queue.Queue()
        self._audio_q: "queue.Queue" = queue.Queue()
        self._stop_event = threading.Event()
        self._tts_done = threading.Event()
        self._tts_done.set()
        self._play_done = threading.Event()
        self._play_done.set()
        self._tts_thread: Optional[threading.Thread] = None
        self._play_thread: Optional[threading.Thread] = None
        # per-session state
        self._synth_fn: Optional[Callable[[str], Optional[np.ndarray]]] = None
        self._play = False
        self._split = True
        self._save_path: Optional[str] = None
        self._chunk_cb: Optional[Callable[[Optional[bytes]], None]] = None
        self._synth_stream_fn = None
        self._session_chunks: List[np.ndarray] = []
        self._sample_rate = SAMPLE_RATE
        self.first_error: Optional[Exception] = None

    # -- lifecycle --------------------------------------------------------

    def start_session(
        self,
        synth_fn: Callable[[str], Optional[np.ndarray]],
        play: bool = False,
        split: bool = True,
        save_path: Optional[str] = None,
        chunk_callback: Optional[Callable[[Optional[bytes]], None]] = None,
        synth_stream_fn: Optional[Callable[[str], "object"]] = None,
        sample_rate: int = SAMPLE_RATE,
    ) -> None:
        """Begin a synthesis session. ``synth_fn(sentence) -> waveform``.

        ``synth_stream_fn(sentence) -> iterator[waveform chunks]`` enables
        intra-utterance streaming (used when a chunk callback is set).
        ``sample_rate``: the waveforms' rate (a V4 character's is 48 kHz),
        at which they are saved and played."""
        with self._api_lock:
            self._stop_event.clear()
            self._tts_done.clear()
            self.first_error = None
            self._synth_fn = synth_fn
            self._synth_stream_fn = synth_stream_fn
            self._play = play and _HAS_AUDIO_OUT
            if play and not _HAS_AUDIO_OUT:
                logger.warning("sounddevice unavailable; play=True ignored")
            self._split = split
            self._save_path = save_path
            self._sample_rate = int(sample_rate)
            self._chunk_cb = chunk_callback
            self._session_chunks = []
            if self._play:
                self._play_done.clear()
            if self._tts_thread is None or not self._tts_thread.is_alive():
                self._tts_thread = threading.Thread(
                    target=self._tts_worker, daemon=True, name="tts-worker")
                self._tts_thread.start()
            if self._play and (self._play_thread is None
                               or not self._play_thread.is_alive()):
                self._play_thread = threading.Thread(
                    target=self._playback_worker, daemon=True, name="tts-playback")
                self._play_thread.start()

    def feed(self, text: str) -> None:
        with self._api_lock:
            sentences = split_text(text) if self._split else [text]
            for s in sentences:
                self._text_q.put(s)

    def end_session(self) -> None:
        with self._api_lock:
            self._text_q.put(_STREAM_END)

    def stop(self) -> None:
        """Abort current synthesis + drain queues (reference
        ``TTSPlayer.stop``)."""
        with self._api_lock:
            self._stop_event.set()
            _drain(self._text_q)
            _drain(self._audio_q)
            self._tts_done.set()
            self._play_done.set()

    def wait_for_tts_completion(self) -> None:
        self._tts_done.wait()

    def wait_for_playback_done(self) -> None:
        self._tts_done.wait()
        self._play_done.wait()

    # -- workers ----------------------------------------------------------

    @torch.inference_mode()
    def _tts_worker(self) -> None:
        while True:
            item = self._text_q.get()
            if item is _STREAM_END:
                self._finish_session()
            elif not self._stop_event.is_set():
                self._synthesize(item)

    def _synthesize(self, item: str) -> None:
        """One sentence through the session's synth function (or, with a
        chunk callback, its stream function). A failure is logged and the
        first one kept, not raised: per-sentence isolation, and callers
        (HTTP /tts) report it when the whole session produced nothing."""
        try:
            stream_fn = self._synth_stream_fn
            if self._chunk_cb is not None and stream_fn is not None:
                # intra-utterance streaming: emit vocoder chunks live
                for piece in stream_fn(item):
                    if self._stop_event.is_set():
                        break
                    self._emit(piece)
                return
            audio = self._synth_fn(item)
        except Exception as e:
            logger.exception("synthesis failed for %r", item)
            if self.first_error is None:
                self.first_error = e
            return
        if audio is not None and not self._stop_event.is_set():
            self._emit(audio)

    def _emit(self, audio: np.ndarray) -> None:
        if self._chunk_cb is not None:
            self._chunk_cb(pcm16_bytes(audio))
        if self._save_path:
            self._session_chunks.append(as_float(audio))
        if self._play:
            self._audio_q.put(as_float(audio))

    def _finish_session(self) -> None:
        if self._save_path and self._session_chunks:
            try:
                write_wav(self._save_path,
                          np.concatenate(self._session_chunks), self._sample_rate)
                logger.info("saved %s", self._save_path)
            except Exception:
                logger.exception("failed saving %s", self._save_path)
        self._session_chunks = []
        if self._chunk_cb is not None:
            self._chunk_cb(None)
        if self._play:
            self._audio_q.put(_AUDIO_END)
        # the worker outlives the session: it must not keep the synth
        # functions (and the character they close over) alive
        self._synth_fn = self._synth_stream_fn = self._chunk_cb = None
        self._tts_done.set()

    def _playback_worker(self) -> None:  # pragma: no cover - needs audio HW
        stream = None
        try:
            stream = sounddevice.OutputStream(
                samplerate=self._sample_rate, channels=1, dtype="float32")
            stream.start()
            while True:
                item = self._audio_q.get()
                if item is _AUDIO_END:
                    self._play_done.set()
                    continue
                if self._stop_event.is_set():
                    continue
                stream.write(np.ascontiguousarray(item, np.float32))
        except Exception:
            logger.exception("playback worker died")
            self._play_done.set()
        finally:
            if stream is not None:
                stream.close()


def _drain(q: "queue.Queue") -> None:
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


class SessionRegistry:
    """Tracks live sessions so ``stop()`` reaches all of them. Every
    request gets its own session; the registry only serves the global
    stop/wait surface."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sessions: List[TTSSession] = []

    def create(self) -> TTSSession:
        s = TTSSession()
        with self._lock:
            self._sessions = [x for x in self._sessions if not x._tts_done.is_set()
                              or x is s] + [s]
        return s

    def stop_all(self) -> None:
        with self._lock:
            sessions = list(self._sessions)
        for s in sessions:
            s.stop()

    def wait_all(self) -> None:
        with self._lock:
            sessions = list(self._sessions)
        for s in sessions:
            s.wait_for_playback_done()


session_registry = SessionRegistry()

# Default shared session for the simple sequential API (``tts`` from one
# thread); concurrent paths (server requests, tts_async) create isolated
# sessions via the registry.
tts_session = TTSSession()
