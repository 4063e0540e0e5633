"""Public Python API of the port: load_character, unload_character,
set_reference_audio, tts, tts_async, stop, wait_for_playback_done,
clear_reference_audio_cache, start_server, convert_model (and its alias
convert_to_onnx).

The port of ``genie_tts_tpu/api.py`` for V2 and V2ProPlus characters
(a V2ProPlus character clones through the speaker-verification model of
``models/sv.py``) speaking Japanese, English, Chinese or hybrid
Chinese-English text (Chinese text takes RoBERTa BERT features, loaded
with the character). ``tts`` and
``tts_async`` run through sessions (``runtime/session.py``); the serving
route (``_make_synth_fn(use_batcher=True)``) sends a sentence that fits
the slot buckets to the character's in-flight slot machine and any other
to the window batcher; streams go to the busy slot machine, else to the
solo segmented stream or the fused stream head. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; with no GPU and no
device named they raise.

``GENIE_MESH="DPxTP"`` (read at import) serves over ``dp * tp`` cards from
this one process: the module's engine is built on that serving mesh and
``load_character`` places each character on it (``TTSEngine.
shard_character``: a replica per dp row, the T2S decoder tp-sharded over
the row's cards). With fewer cards than ``dp * tp`` the import raises.

Warmth belongs to a configuration, as in the JAX package (its jitted
programs take the weights as an argument): the captured graphs are the
configuration's and read its bank, which each character binds
(``runtime/graphs.py``). ``serve --warmup`` sweeps the warmup character
(``engine.warmup(char, ref, sweep=True)``) and sets
``sweep_on_reference``; a character is then swept at its
``set_reference_audio`` only when its configuration has not been swept
at that clip's prompt bucket (``engine.swept``), so every later
character of a swept configuration, a reload after an eviction
included, runs 0 sweep units and captures nothing. An evicted or
unloaded character's slot machine is retired (it finishes the requests
it holds, then exits), so its weights and states go with it; the
configuration's graphs, bank and resident states stay, as the JAX jit
caches do. ``unload_character`` waits for the machine to stop, and
every machine is joined before the interpreter ends
(:func:`_join_slot_machines`), so a process may exit right after an
unload or an eviction.
"""
from __future__ import annotations

import asyncio
import logging
import os
import threading
import time
import weakref
from os import PathLike
from typing import AsyncIterator, Dict, Optional, Union

import numpy as np
import torch

from .config import RuntimeConfig, indexed_device, resolve_device
from .frontend.dispatcher import get_phones_and_bert
from .frontend.language import MONOLINGUAL, normalize_language, require_supported
from .ops.sampling import SamplingConfig
from .runtime.engine import TTSEngine
from .runtime.model_manager import model_manager
from .runtime.reference_audio import reference_audio_cache
from .runtime.session import session_registry, tts_session
from .utils.wavio import as_float

logger = logging.getLogger(__name__)

SUPPORTED_AUDIO_EXTS = {".wav", ".flac", ".ogg", ".aiff", ".aif"}


def _serving_mesh():
    """The serving mesh of ``GENIE_MESH="DPxTP"`` (e.g. "2x2": the batch
    splits over 2 dp rows, each decoding tp-sharded over 2 cards), or None
    when it is unset or 1x1. A bad spec raises ValueError, and so does a
    mesh larger than the cards present (``make_serving_mesh``)."""
    spec = os.environ.get("GENIE_MESH", "")
    if not spec:
        return None
    try:
        dp, tp = (int(x) for x in spec.lower().split("x"))
    except ValueError as e:
        raise ValueError(f"GENIE_MESH must be 'DPxTP', got {spec!r}") from e
    if dp * tp <= 1:
        return None
    from .parallel.mesh import make_serving_mesh

    return make_serving_mesh(dp, tp)


engine = TTSEngine(RuntimeConfig(), mesh=_serving_mesh())

# character -> reference-audio config
_reference_audios: Dict[str, dict] = {}
# set by ``serve --warmup``: sweep every configuration not swept yet before
# a character of it serves (``engine.swept`` records the swept ones)
sweep_on_reference = False
_sweep_lock = threading.Lock()
# device -> (the HuBERT params it closes over, forward)
_hubert_fns: Dict[torch.device, tuple] = {}


def _hubert_fn(device):
    """HuBERT forward on ``device``, or None when weights are unavailable
    (made anew when ``model_manager.set_hubert`` replaced the weights)."""
    dev = resolve_device(device)
    loaded = model_manager.load_hubert(dev)
    if loaded is None:
        return None
    params, hcfg = loaded
    cached = _hubert_fns.get(dev)
    if cached is not None and cached[0] is params:
        return cached[1]
    from .models import hubert as hubert_model

    @torch.inference_mode()
    def fn(audio_16k: np.ndarray) -> np.ndarray:
        audio = torch.as_tensor(np.asarray(audio_16k, np.float32), device=dev)[None]
        return hubert_model.apply(params, audio, hcfg)[0].float().cpu().numpy()

    _hubert_fns[dev] = (params, fn)
    return fn


def _reference_features(char, ref_cfg: dict):
    """The character's cached features of its reference clip (computed on
    first use: HuBERT prompt tokens, and the V2 style embedding or, for
    V2ProPlus, Kaldi fbank -> ERes2NetV2 -> the prompt encoder)."""
    from .models.sv import get_sv_fn

    return reference_audio_cache.get_features(
        engine, char, ref_cfg["audio_path"], ref_cfg["audio_text"],
        ref_cfg["language"], hubert_fn=_hubert_fn(char.device),
        sv_fn=get_sv_fn(char.device) if char.synth.needs_sv else None)


# ---------------------------------------------------------------------------
# Character management
# ---------------------------------------------------------------------------

def load_character(character_name: str, model_dir: Union[str, PathLike],
                   language: str, device=None, dtype=None) -> None:
    """Load a character checkpoint directory (t2s/vits safetensors) onto
    ``device`` (cuda unless named) in ``dtype`` (default bf16). With a
    serving mesh the character loads on the mesh's first device and is
    placed on the mesh (``engine.shard_character``); a ``device`` that
    names another device raises."""
    language = require_supported(language)
    mesh = engine.mesh
    if mesh is not None:
        if device is not None and indexed_device(resolve_device(device)) != mesh.lead:
            raise ValueError(f"device {device} is not the serving mesh's first "
                             f"device {mesh.lead}")
        device = mesh.lead
    if "Chinese" in language:  # Chinese/Hybrid: warm the BERT feature model
        model_manager.load_roberta(device)
    char = model_manager.load_character(character_name, os.fspath(model_dir), language,
                                        compute_dtype=dtype, device=device)
    if mesh is not None:
        engine.shard_character(char)


# how long an unload, and the interpreter's end, wait for slot machines
_JOIN_S = 60.0


def unload_character(character_name: str) -> None:
    """Unload a character: its weights go, and its slot machine finishes
    the requests it holds and stops; this waits up to ``_JOIN_S`` seconds
    for that, so a process may end right after it."""
    model_manager.remove_character(character_name)
    sb = _release_character(character_name)
    if sb is not None:
        sb.join(_JOIN_S)


def _release_character(character_name: str):
    """Let go of what the API holds for a character that left the cache
    (unloaded or evicted): its slot machine, retired (it finishes the
    requests queued and in flight in it, then exits; joined at exit by
    :func:`_join_slot_machines`), which is returned. Then nothing keeps
    the character, so its weights and its machine's state are freed,
    every dp replica's on a mesh; the graphs of its configuration stay
    for the next character."""
    with _slot_batchers_lock:
        sb = _slot_batchers.pop(character_name, None)
    if sb is not None:
        sb.retire()
        _retired.add(sb)
    return sb


# retired slot machines not yet stopped (their loops drain on daemon threads)
_retired: "weakref.WeakSet" = weakref.WeakSet()


def _join_slot_machines() -> None:
    """Let every slot machine finish what it holds and stop, waiting up to
    ``_JOIN_S`` seconds in all: a process that ended while a machine's
    daemon thread was still inside torch would abort at exit. Run when
    the interpreter ends, before the thread pools the machines hand work
    to shut down."""
    with _slot_batchers_lock:
        machines = list(_slot_batchers.values()) + list(_retired)
    deadline = time.monotonic() + _JOIN_S
    for sb in machines:
        sb.retire()
        sb.join(max(deadline - time.monotonic(), 0.0))


# ``threading._register_atexit``: run before the interpreter joins its
# threads and shuts the thread pools down (a plain ``atexit`` handler runs
# after that, when a draining machine could no longer vocode)
threading._register_atexit(_join_slot_machines)


model_manager.on_evict = _release_character


def set_reference_audio(character_name: str, audio_path: Union[str, PathLike],
                        audio_text: str, language: Optional[str] = None,
                        device=None) -> bool:
    """Register the voice-cloning reference clip for a character and run
    its HuBERT features on the character's device (or ``device``); for a
    loaded character whose HuBERT is available, its speaker features too
    (``_reference_features``).

    Returns False (after logging) for unsupported formats."""
    audio_path = os.fspath(audio_path)
    ext = os.path.splitext(audio_path)[1].lower()
    if ext not in SUPPORTED_AUDIO_EXTS:
        logger.error("Audio format '%s' not supported (supported: %s)",
                     ext, sorted(SUPPORTED_AUDIO_EXTS))
        return False
    model = model_manager.get(character_name)
    if language is None:
        if model is None:
            raise ValueError("No language specified and character not loaded")
        language = model.language
    language = normalize_language(language)
    if language not in MONOLINGUAL:
        raise ValueError(f"Unknown language: {language}")
    if device is None and model is not None:
        device = model.device
    ref_cfg = {"audio_path": audio_path, "audio_text": audio_text, "language": language}
    _reference_audios[character_name] = ref_cfg
    hubert_fn = _hubert_fn(device)
    reference_audio_cache.get_clip(audio_path, audio_text, language, hubert_fn=hubert_fn)
    if model is not None and hubert_fn is not None:
        _sweep(model, _reference_features(model, ref_cfg))
    return True


def _sweep(char, feats, always: bool = False) -> int:
    """The warmup sweep of ``char``'s configuration at the prompt bucket of
    ``feats`` (``engine.warmup(..., sweep=True)``, which runs 0 units for
    a configuration and bucket swept already); only with
    ``sweep_on_reference`` set (``serve --warmup``) or ``always``.
    Returns the units run (0: nothing to do)."""
    if not (always or sweep_on_reference) or not engine.needs_sweep(char, feats):
        return 0
    with _sweep_lock:                 # one sweep at a time: a capture syncs the card
        return engine.warmup(char, feats, sweep=True)


def warmup_character(character_name: str) -> int:
    """The warmup sweep (``engine.warmup(char, ref, sweep=True)``) for a
    loaded character with its reference clip set: every graph the
    requests of its configuration can reach is captured before they
    arrive. Returns the units run (0 when the configuration was swept at
    this clip's prompt bucket already)."""
    char = model_manager.get(character_name)
    if char is None:
        raise ValueError(f"character {character_name!r} is not loaded")
    if character_name not in _reference_audios:
        raise ValueError("set_reference_audio has not been called")
    return _sweep(char, _reference_features(char, _reference_audios[character_name]),
                  always=True)


def clear_reference_audio_cache() -> None:
    reference_audio_cache.clear()


# ---------------------------------------------------------------------------
# Synthesis
# ---------------------------------------------------------------------------

_batcher = None
_batcher_lock = threading.Lock()


def get_batcher():
    """Lazy global window batcher (``runtime/batcher.py``) bound to the
    engine: the serving route of sentences that do not fit the slot
    machine."""
    global _batcher
    with _batcher_lock:
        if _batcher is None:
            from .runtime.batcher import ContinuousBatcher

            _batcher = ContinuousBatcher(engine, max_batch=engine.cfg.batch_max,
                                         window_ms=engine.cfg.batch_window_ms)
        return _batcher


_slot_batchers: dict = {}
_slot_batchers_lock = threading.Lock()


def get_slot_batcher(char):
    """Lazy per-character SlotBatcher (in-flight continuous batching), or
    None for a character object no longer loaded (evicted or unloaded:
    its machine is draining, and a new one would keep it alive).

    Locked: two concurrent first requests must not each build a batcher
    (the loser would leak a scheduler thread and a slot KV cache)."""
    # asked before the lock: an eviction calls _release_character under
    # the cache's lock
    loaded = model_manager.holds(char)
    with _slot_batchers_lock:
        sb = _slot_batchers.get(char.name)
        if sb is not None and sb.char is char:
            return sb
        if not loaded:
            return None
        if sb is not None:             # an earlier object of this name
            sb.retire()
        from .runtime.slot_batcher import SlotBatcher

        # serving emits PCM16, made on the device
        sb = SlotBatcher(engine, char, pcm16=True)
        _slot_batchers[char.name] = sb
        return sb


def _make_synth_fn(character_name: str, sampling: Optional[SamplingConfig] = None,
                   use_batcher: bool = False):
    """(synth, synth_stream) for one character: sentence -> waveform, and
    sentence -> iterator of waveform pieces.

    ``use_batcher`` (the serving route): a sentence that fits the slot
    machine's buckets joins the character's slot batcher and comes back
    as int16 PCM, decoding in flight beside concurrent requests (with
    ``RuntimeConfig.serve_slots``); any other goes to the window batcher,
    which runs concurrent arrivals as one batch. Without ``use_batcher``
    every sentence is synthesized solo (float32).

    ``synth_stream``: when the slot machine is busy (or every slot row
    pumps windows) a sentence that fits it joins as a streaming row;
    otherwise the solo segmented stream, or the fused stream head for a
    sentence too long for the stream geometry."""
    char = model_manager.get(character_name)
    if char is None:
        raise ValueError(f"Character '{character_name}' is not loaded")
    feats = _reference_features(char, _reference_audios[character_name])
    _sweep(char, feats)          # a configuration not swept yet at this bucket

    def synth(sentence: str) -> Optional[np.ndarray]:
        # a leading 。 guards against the model swallowing the first phrase
        phones, bert = get_phones_and_bert("。" + sentence, char.language)
        if len(phones) == 0:
            return None
        if use_batcher:
            if engine.cfg.serve_slots:
                # per-request sampling joins too: it is per-row slot state
                sb = get_slot_batcher(char)
                if sb is not None and sb.fits(feats, phones):
                    return sb.synthesize(feats, phones, bert, sampling=sampling)
            return get_batcher().synthesize(char, feats, phones, bert,
                                            sampling=sampling)
        return engine.synthesize_utterance(char, feats, phones, bert,
                                           sampling=sampling)

    def synth_stream(sentence: str):
        phones, bert = get_phones_and_bert("。" + sentence, char.language)
        if len(phones) == 0:
            return
        if engine.cfg.serve_slots:
            sb = get_slot_batcher(char)
            if sb is not None and sb.fits(feats, phones) and (
                    engine.cfg.slot_stream_finisher or sb._occupied() or not sb._q.empty()):
                yield from sb.synthesize_stream(feats, phones, bert, sampling=sampling)
                return
        yield from engine.synthesize_utterance_stream(char, feats, phones, bert,
                                                      sampling=sampling)

    return synth, synth_stream


def sample_rate(character_name: str) -> int:
    """The rate of a loaded character's audio: 32000, or 48000 for V4."""
    char = model_manager.get(character_name)
    if char is None:
        raise ValueError(f"Character '{character_name}' is not loaded")
    return char.sample_rate


def _prepare_save_path(save_path) -> Optional[str]:
    if not save_path:
        return None
    save_path = os.fspath(save_path)
    parent = os.path.dirname(save_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    return save_path


# one tts() call at a time owns the default session: a second caller's
# start_session would swap the synth function under the first's sentences
_tts_lock = threading.Lock()


def tts(character_name: str, text: str, play: bool = False,
        split_sentence: bool = True, save_path: Union[str, PathLike, None] = None,
        sampling: Optional[SamplingConfig] = None) -> Optional[np.ndarray]:
    """Blocking synthesis of ``text`` sentence by sentence on the
    character's device, through the default session: optionally played
    (``play``, where sounddevice is installed) and saved as one wav.
    Concurrent calls take turns; a sentence that fails raises its error.

    Returns the float32 waveform of all sentences at the character's rate
    (32 kHz; a V4 character's 48 kHz: :func:`sample_rate`)."""
    if character_name not in _reference_audios:
        logger.error("Call set_reference_audio first to set the reference audio.")
        return None
    synth, _ = _make_synth_fn(character_name, sampling)
    pieces = []

    def collect(sentence):
        audio = synth(sentence)
        if audio is not None:
            pieces.append(as_float(audio))
        return audio

    with _tts_lock:
        tts_session.start_session(collect, play=play, split=split_sentence,
                                  save_path=_prepare_save_path(save_path),
                                  sample_rate=sample_rate(character_name))
        tts_session.feed(text)
        tts_session.end_session()
        tts_session.wait_for_tts_completion()
        if tts_session.first_error is not None:
            raise tts_session.first_error
    return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)


async def tts_async(character_name: str, text: str, play: bool = False,
                    split_sentence: bool = False,
                    save_path: Union[str, PathLike, None] = None,
                    sampling: Optional[SamplingConfig] = None) -> AsyncIterator[bytes]:
    """Async generator of PCM16 chunks (pieces of each sentence as the
    stream route emits them), on a session of its own."""
    if character_name not in _reference_audios:
        raise ValueError("Call set_reference_audio first to set the reference audio.")
    stream_q: asyncio.Queue = asyncio.Queue()
    loop = asyncio.get_running_loop()

    def chunk_cb(chunk: Optional[bytes]) -> None:
        loop.call_soon_threadsafe(stream_q.put_nowait, chunk)

    synth, synth_stream = _make_synth_fn(character_name, sampling)
    session = session_registry.create()  # concurrent calls do not interleave
    session.start_session(synth, play=play, split=split_sentence,
                          save_path=_prepare_save_path(save_path),
                          chunk_callback=chunk_cb, synth_stream_fn=synth_stream,
                          sample_rate=sample_rate(character_name))
    session.feed(text)
    session.end_session()
    while True:
        chunk = await stream_q.get()
        if chunk is None:
            break
        yield chunk


def stop() -> None:
    tts_session.stop()
    session_registry.stop_all()


def wait_for_playback_done() -> None:
    tts_session.wait_for_playback_done()
    session_registry.wait_all()


def start_server(host: str = "127.0.0.1", port: int = 8000, workers: int = 1,
                 block: bool = True, device=None):
    """Serve the HTTP API (``server/http.py``); characters and reference
    clips it loads go to ``device`` (cuda unless named). Returns the
    server (with ``block=False`` it serves on a thread of its own)."""
    from .server.http import start_server as _start

    return _start(host=host, port=port, workers=workers, block=block, device=device)


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------

def convert_model(torch_ckpt_path: Union[str, PathLike],
                  torch_pth_path: Union[str, PathLike],
                  output_dir: Union[str, PathLike],
                  language: str = "Japanese") -> None:
    """Convert GPT-SoVITS torch checkpoints to a character checkpoint dir
    (``convert/torch_convert.py::convert_character``; the version is
    detected from the ``.pth``)."""
    from .convert.torch_convert import convert_character

    convert_character(os.fspath(torch_ckpt_path), os.fspath(torch_pth_path),
                      os.fspath(output_dir), language=language)


def convert_to_onnx(torch_ckpt_path, torch_pth_path, output_dir) -> None:
    """Reference-API-compatible alias of :func:`convert_model` (it writes
    safetensors checkpoints, not ONNX graphs)."""
    convert_model(torch_ckpt_path, torch_pth_path, output_dir)
