"""TTS inference engine: one sentence -> 32 kHz waveform.

The solo path of ``genie_tts_tpu/runtime/engine.py``:

  phones (host G2P) -> [bucket] -> T2S prefill + AR decode -> semantic
  codes -> SoVITS latent -> chunked HiFi-GAN -> waveform,

and the batched codes -> waveform tail (``vocode_codes_*``) that the slot
scheduler (``runtime/slot_batcher.py``) runs on the codes it decoded.

Lengths are padded to the same bucket ladders as the JAX package, so both
packages see the same shapes (and the same masks) for a given input.
Reference-audio features (HuBERT -> VQ prompt tokens, V2 style
embedding) are computed once per reference clip and cached by
``runtime/reference_audio.py``.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import RuntimeConfig, SoVITSConfig, T2SConfig, resolve_device
from ..models import sovits, t2s
from ..ops.audio import linear_spectrogram
from ..ops.sampling import SamplingConfig
from ..utils.metrics import metrics
from .buckets import pad_to, pick_bucket

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CharacterModel:
    """Loaded weights for one character (t2s + sovits) on one device."""
    name: str
    language: str
    version: str                    # "v2"
    t2s_params: Dict
    sovits_params: Dict
    t2s_cfg: T2SConfig
    sovits_cfg: SoVITSConfig
    device: torch.device = torch.device("cpu")


@dataclasses.dataclass
class ReferenceFeatures:
    """Per-reference-clip features."""
    phones: np.ndarray              # [Tr] int32 phoneme ids of the transcript
    bert: np.ndarray                # [Tr, 1024] fp32
    prompt_tokens: np.ndarray       # [Tp] int32 semantic VQ tokens
    ge: np.ndarray                  # [gin, 1] speaker embedding (flow/dec)
    ge_mrte: np.ndarray             # [512, 1] speaker embedding (MRTE)


def _to_pcm16(audio: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(audio, -1.0, 1.0) * 32767.0).to(torch.int16)


def _fit_codes(codes: torch.Tensor, bucket: int) -> torch.Tensor:
    if bucket < codes.shape[1]:
        return codes[:, :bucket]
    if bucket > codes.shape[1]:
        return torch.nn.functional.pad(codes, (0, bucket - codes.shape[1]))
    return codes


def host_to_device(a, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device: through
    pinned memory with a non-blocking copy (a pageable copy would wait for
    the work already queued on the stream)."""
    t = torch.as_tensor(np.asarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def start_host_copy(t: torch.Tensor):
    """Enqueue ``t``'s copy to host memory behind the work that made it;
    :func:`finish_host_copy` waits for it. On the CPU the tensor is its own
    copy."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return host, event


def finish_host_copy(handle) -> np.ndarray:
    host, event = handle
    if event is not None:
        event.synchronize()
    return host.numpy()


class _Stages:
    """Wall time of the pipeline's stages; with ``on``, each mark waits for
    the device first, so a stage's time is its own."""

    def __init__(self, on: bool, device: torch.device):
        self.on, self.device = on, device
        self.times: Dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        if not self.on:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.times[name] = self.times.get(name, 0.0) + now - self._t
        self._t = now


def _t2s_and_vocode(t2s_params, sovits_params, tcfg, vcfg, scfg, generator,
                    phones, bert, x_len, prompts, p_len, text, t_len, ge,
                    ge_mrte, noise_scale, max_steps, cache_len, min_steps,
                    codes_bucket=None, pcm16=False, max_steps_dyn=None,
                    vocode_chunk=0, vocode_halo=0, stages=None, stats=None):
    """Whole utterance: T2S decode + SoVITS vocode, no host read between
    them. ``codes_bucket`` sizes the vocoder stage (default ``max_steps``);
    padded frames are masked and the caller trims to
    ``2 * codes_len * hop`` samples."""
    codes, codes_len = t2s.generate_e2e(
        t2s_params, tcfg, scfg, generator, phones, bert, x_len, prompts, p_len,
        max_steps=max_steps, cache_len=cache_len, min_steps=min_steps,
        max_steps_dyn=max_steps_dyn, stats=stats)
    if stages is not None:
        stages.mark("decode")
    codes = _fit_codes(codes, codes_bucket or max_steps)
    z = sovits.synthesize_latent(sovits_params, vcfg, codes, codes_len, text,
                                 t_len, ge, ge_mrte, noise_scale,
                                 generator=generator)
    if stages is not None:
        stages.mark("latent")
    if vocode_chunk:
        audio = sovits.vocode_frames_chunked(sovits_params, vcfg, z, ge,
                                             2 * codes_len, chunk=vocode_chunk,
                                             halo=vocode_halo)
    else:
        audio = sovits.vocode_frames(sovits_params, vcfg, z, ge, 2 * codes_len)
    if stages is not None:
        stages.mark("vocode")
    if pcm16:
        audio = _to_pcm16(audio)
    return audio, codes_len


class TTSEngine:
    """Solo synthesis on a character's device.

    ``timing``: record each utterance's stage times (decode, latent,
    vocode, host), synchronizing the device at every stage boundary, in
    ``last_stats``; off by default, since the waits cost time."""

    def __init__(self, runtime_cfg: Optional[RuntimeConfig] = None,
                 timing: bool = False):
        self.cfg = runtime_cfg or RuntimeConfig()
        self.timing = timing
        self.last_stats: Dict = {}
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(0)

    def _next_seed(self) -> int:
        with self._lock:
            return int(self._rng.integers(0, 2 ** 31 - 1))

    # -- reference feature extraction ------------------------------------

    @torch.inference_mode()
    def compute_prompt_tokens(self, char: CharacterModel,
                              ssl_content: np.ndarray) -> np.ndarray:
        """HuBERT features [T,768] -> semantic prompt ids [T//2]."""
        ssl = torch.as_tensor(np.asarray(ssl_content, np.float32),
                              device=char.device)[None]
        toks = t2s.extract_prompt_tokens(char.t2s_params, ssl)
        return toks[0].cpu().numpy().astype(np.int32)

    @torch.inference_mode()
    def compute_v2_speaker_embedding(self, char: CharacterModel,
                                     audio_32k: np.ndarray) -> np.ndarray:
        """V2 path: ref waveform -> linear spec -> MelStyleEncoder -> ge."""
        cfg = char.sovits_cfg
        audio = torch.as_tensor(np.asarray(audio_32k, np.float32),
                                device=char.device)[None]
        spec = linear_spectrogram(audio, n_fft=cfg.n_fft, hop=cfg.hop_length,
                                  win_length=cfg.win_length)
        ge = sovits.reference_embedding(
            char.sovits_params, cfg, spec,
            torch.tensor([spec.shape[1]], device=char.device))
        return ge[0].float().cpu().numpy()

    # -- synthesis --------------------------------------------------------

    @torch.inference_mode()
    def synthesize_utterance(self, char: CharacterModel, ref: ReferenceFeatures,
                             text_phones: np.ndarray, text_bert: np.ndarray,
                             sampling: Optional[SamplingConfig] = None,
                             seed: Optional[int] = None,
                             noise_scale: float = 0.5,
                             fixed_steps: Optional[int] = None,
                             min_steps: int = 0,
                             max_steps: Optional[int] = None,
                             pcm16: bool = False) -> np.ndarray:
        """One sentence -> waveform [S] at 32 kHz (float32, or int16 with
        ``pcm16``).

        When the decode cap fits ``solo_fused_max_codes`` (or the length is
        pinned with ``fixed_steps``) the whole cap is vocoded right after
        decode with no host read between the stages; above it, the
        emitted length is read first and a frame bucket of it is vocoded.
        """
        scfg = sampling or SamplingConfig()
        tcfg, vcfg = char.t2s_cfg, char.sovits_cfg
        dev = char.device
        if seed is None:
            seed = self._next_seed()
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        stages = _Stages(self.timing, dev)
        stats: Dict = {}

        def ids(a, n):
            return torch.as_tensor(pad_to(np.asarray(a, np.int64), n),
                                   device=dev)[None]

        # ---- T2S: pack [ref_text | text]
        phones = np.concatenate([ref.phones, text_phones]).astype(np.int64)
        x_bucket = pick_bucket(len(phones), self.cfg.phoneme_buckets)
        p_bucket = pick_bucket(len(ref.prompt_tokens), self.cfg.prompt_buckets)
        # beyond the largest bucket the data is truncated; clamped lengths
        # keep unwritten cache positions out of the attention masks
        x_len = min(len(phones), x_bucket)
        p_len = min(len(ref.prompt_tokens), p_bucket)
        max_steps = fixed_steps or max_steps or tcfg.max_decode_steps
        if np.any(ref.bert) or np.any(text_bert):
            bert = np.concatenate([ref.bert, text_bert]).astype(np.float32)
            bert_dev = torch.as_tensor(pad_to(bert, x_bucket, axis=0),
                                       device=dev)[None]
        else:
            bert_dev = None  # all-zero BERT (the JA path)
        t_bucket = pick_bucket(len(text_phones), self.cfg.phoneme_buckets)
        text = ids(text_phones, t_bucket)
        t_len = torch.tensor([min(len(text_phones), t_bucket)], device=dev)
        ge = torch.as_tensor(ref.ge, device=dev)[None].float()
        ge_mrte = torch.as_tensor(ref.ge_mrte, device=dev)[None].float()
        cap = (fixed_steps if fixed_steps is not None
               else pick_bucket(max_steps, self.cfg.step_caps))
        args = dict(phones=ids(phones, x_bucket), bert=bert_dev,
                    x_len=torch.tensor([x_len], device=dev),
                    prompts=ids(ref.prompt_tokens, p_bucket),
                    p_len=torch.tensor([p_len], device=dev))
        min_steps = fixed_steps if fixed_steps is not None else min_steps
        stages.mark("host")

        if fixed_steps is not None or cap <= self.cfg.solo_fused_max_codes:
            audio, codes_len = _t2s_and_vocode(
                char.t2s_params, char.sovits_params, tcfg, vcfg, scfg, gen,
                text=text, t_len=t_len, ge=ge, ge_mrte=ge_mrte,
                noise_scale=noise_scale, max_steps=cap,
                cache_len=x_bucket + p_bucket + cap, min_steps=min_steps,
                max_steps_dyn=max_steps, codes_bucket=cap,
                vocode_chunk=self.cfg.vocode_chunk,
                vocode_halo=self.cfg.vocode_halo, pcm16=pcm16,
                stages=stages, stats=stats, **args)
            n_codes = int(codes_len[0])
            out = audio[0, :2 * n_codes * vcfg.hop_length].cpu().numpy()
        else:
            codes, codes_len = t2s.generate_e2e(
                char.t2s_params, tcfg, scfg, gen, max_steps=cap,
                cache_len=x_bucket + p_bucket + cap, min_steps=min_steps,
                max_steps_dyn=max_steps, stats=stats, **args)
            stages.mark("decode")
            n_codes = int(codes_len[0])
            if n_codes == 0:
                logger.warning("T2S produced no semantic tokens; returning silence")
                return np.zeros(0, np.int16 if pcm16 else np.float32)
            codes = _fit_codes(codes, pick_bucket(n_codes, self.cfg.frame_buckets))
            z = sovits.synthesize_latent(char.sovits_params, vcfg, codes,
                                         codes_len, text, t_len, ge, ge_mrte,
                                         noise_scale, generator=gen)
            stages.mark("latent")
            audio = sovits.vocode_frames_chunked(
                char.sovits_params, vcfg, z, ge, 2 * codes_len,
                chunk=self.cfg.vocode_chunk, halo=self.cfg.vocode_halo)
            stages.mark("vocode")
            audio = audio[0, :2 * n_codes * vcfg.hop_length]
            out = (_to_pcm16(audio) if pcm16 else audio).cpu().numpy()
        stages.mark("host")
        self.last_stats = {"codes_len": n_codes, **stats, "stages": stages.times}
        return out if pcm16 else out.astype(np.float32)

    # -- batched codes -> waveform tail (the slot finisher) ----------------

    def vocode_codes(self, char: CharacterModel, ref: ReferenceFeatures,
                     text_phones: np.ndarray, codes: np.ndarray, seed: int = 0,
                     noise_scale: float = 0.5, pcm16: bool = False) -> np.ndarray:
        """Semantic codes [n] -> waveform for one utterance."""
        return self.vocode_codes_batch(char, [(ref, text_phones, codes)], seed=seed,
                                       noise_scale=noise_scale, pcm16=pcm16)[0]

    def vocode_codes_batch(self, char: CharacterModel, items, seed: int = 0,
                           noise_scale: float = 0.5, b_buckets=None,
                           t_buckets=None, pcm16: bool = False, noise=None):
        """Batched codes -> waveform tail (dispatch + fetch in one call)."""
        return self.vocode_codes_fetch(self.vocode_codes_dispatch(
            char, items, seed=seed, noise_scale=noise_scale, b_buckets=b_buckets,
            t_buckets=t_buckets, pcm16=pcm16, noise=noise))

    @torch.inference_mode()
    def vocode_codes_dispatch(self, char: CharacterModel, items, seed: int = 0,
                              noise_scale: float = 0.5, b_buckets=None,
                              t_buckets=None, pcm16: bool = False, noise=None):
        """Device half of the batched tail: ``items`` = [(ref, text_phones,
        codes)] vocode as ONE batch, padded to ``b_buckets`` (default
        ``batch_buckets``) with copies of the first row, codes to a
        ``frame_buckets`` bucket and text to one ``t_buckets`` bucket; one
        ``synthesize_latent``, a chunked HiFi-GAN, PCM16 made on the device
        when ``pcm16``. The waveform's copy to host memory is enqueued
        right behind it; the returned handle goes to
        :meth:`vocode_codes_fetch`, which may run on any thread.

        The flow noise is drawn from a generator seeded with ``seed``, or
        given as ``noise`` [len(items), F, 192] (frames beyond a row's
        codes are masked; F is cut or zero-padded to the frame bucket)."""
        vcfg = char.sovits_cfg
        dev = char.device
        B = len(items)
        lens = np.array([len(c) for (_, _, c) in items], np.int64)
        if B == 0 or int(lens.max()) == 0:
            empty = torch.zeros((B, 0), dtype=torch.int16 if pcm16 else torch.float32)
            return (empty, None), lens, vcfg.hop_length
        B_pad = max(pick_bucket(B, b_buckets or self.cfg.batch_buckets), B)
        items = list(items) + [items[0]] * (B_pad - B)
        lens = np.concatenate([lens, lens[:1].repeat(B_pad - B)])
        c_bucket = pick_bucket(int(lens.max()), self.cfg.frame_buckets)
        lens = np.minimum(lens, c_bucket)           # truncated past the ladder
        codes_b = np.stack([pad_to(np.asarray(c[:c_bucket], np.int64), c_bucket)
                            for (_, _, c) in items])
        t_lens = np.array([len(tp) for (_, tp, _) in items], np.int64)
        t_bucket = pick_bucket(int(t_lens.max()), t_buckets or self.cfg.phoneme_buckets)
        t_lens = np.minimum(t_lens, t_bucket)
        text_b = np.stack([pad_to(np.asarray(tp, np.int64), t_bucket)
                           for (_, tp, _) in items])
        ge_b = np.stack([r.ge for (r, _, _) in items]).astype(np.float32)
        gm_b = np.stack([r.ge_mrte for (r, _, _) in items]).astype(np.float32)
        lens_d = host_to_device(lens, dev)
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=torch.float32)
            noise = torch.cat([noise, noise[:1].expand(B_pad - B, *noise.shape[1:])])
            F2 = 2 * c_bucket
            noise = (noise[:, :F2] if noise.shape[1] >= F2 else
                     torch.nn.functional.pad(noise, (0, 0, 0, F2 - noise.shape[1])))
            noise = host_to_device(noise, dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        ge = host_to_device(ge_b, dev)
        z = sovits.synthesize_latent(
            char.sovits_params, vcfg, host_to_device(codes_b, dev), lens_d,
            host_to_device(text_b, dev), host_to_device(t_lens, dev), ge,
            host_to_device(gm_b, dev), noise_scale, noise=noise, generator=gen)
        audio = sovits.vocode_frames_chunked(
            char.sovits_params, vcfg, z, ge, 2 * lens_d,
            chunk=self.cfg.vocode_chunk, halo=self.cfg.vocode_halo)[:B]
        audio = _to_pcm16(audio) if pcm16 else audio.float()
        metrics.incr("utterances", B)
        return start_host_copy(audio), lens[:B], vcfg.hop_length

    def vocode_codes_fetch(self, handle):
        """Host half: wait for the waveform's copy and trim each row to
        ``2 * codes * hop`` samples. Runs no device work."""
        copy, lens, hop = handle
        audio = finish_host_copy(copy)
        return [audio[i, : 2 * int(lens[i]) * hop] for i in range(len(lens))]


# ---------------------------------------------------------------------------
# Random character factory (tests and the chip smoke run)
# ---------------------------------------------------------------------------

def make_random_character(name: str = "random", language: str = "Japanese",
                          seed: int = 0, t2s_cfg: Optional[T2SConfig] = None,
                          sovits_cfg: Optional[SoVITSConfig] = None,
                          dtype=torch.bfloat16, eos_boost: float = 1.0,
                          device=None) -> CharacterModel:
    """Random-weight character.

    ``eos_boost``: scale on the EOS column of the predict layer; random
    weights give EOS no edge, and 0 pins its logit at 0, well inside a
    random logit row, so no top-k draw reaches it and every decode runs to
    its cap.
    """
    dev = resolve_device(device)
    tcfg = t2s_cfg or T2SConfig()
    vcfg = sovits_cfg or SoVITSConfig()
    gen = torch.Generator(device=dev).manual_seed(seed)
    t2s_params = t2s.init_params(gen, tcfg, dtype=dtype)
    if eos_boost != 1.0:
        t2s_params["predict"]["w"][:, tcfg.eos_id] *= eos_boost
    return CharacterModel(
        name=name, language=language, version=vcfg.version,
        t2s_params=t2s_params, sovits_params=sovits.init_params(gen, vcfg, dtype=dtype),
        t2s_cfg=tcfg, sovits_cfg=vcfg, device=dev)
