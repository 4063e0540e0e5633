"""TTS inference engine: sentences -> 32 kHz waveforms.

The port of ``genie_tts_tpu/runtime/engine.py``. The solo path:

  phones (host G2P) -> [bucket] -> T2S prefill + AR decode -> semantic
  codes -> SoVITS latent -> chunked HiFi-GAN -> waveform;

its streaming form (``synthesize_utterance_stream``: the segmented stream
of ``runtime/stream.py``, or the fused head that vocodes the first small
window right after decode); ``synthesize_batch`` (the window batcher's:
B >= 2 rows decode through the flash kernel) and ``synthesize_pipelined``;
and the tails the slot scheduler (``runtime/slot_batcher.py``) runs on the
codes it decoded: the batched codes -> waveform finisher
(``vocode_codes_*``) and the per-row window vocode of its window pump
(``vocode_windows_*``).

Serving over a device mesh (``TTSEngine(mesh=make_serving_mesh(dp, tp))``,
``parallel/mesh.py``): ``replicate_character`` / ``shard_character`` give a
character one replica per dp row (each past the first in weights of its
own, marked with its row, so in graphs and a bank of its own), its T2S
layers split over the row's tp
devices by ``shard_character``. ``synthesize_batch`` runs each dp row's
block of the batch on its replica, from a pool of dp threads; every other
path runs on replica 0, whose trees are the character's own fields, so a
path that knows no mesh is unchanged (and tp-sharded where tp > 1). The
warmup sweep captures every replica's graphs for what its row reaches.

Lengths are padded to the same bucket ladders as the JAX package, so both
packages see the same shapes (and the same masks) for a given input.
Reference-audio features (HuBERT -> VQ prompt tokens; the speaker
conditioning of the character's version) are computed once per reference
clip and cached by ``runtime/reference_audio.py``. What differs between
GPT-SoVITS versions (the rate, the reference features, the codes ->
waveform tail, its warm-up, streaming) is the character's synthesizer
object's (``runtime/synthesizers.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import RuntimeConfig, SoVITSConfig, T2SConfig, V4Config, resolve_device
from ..frontend.language import normalize_language
from ..models import sovits, t2s
from ..ops.sampling import SamplingConfig, gumbel_noise
from ..parallel.mesh import place_tree, shard_serving_params
from ..parallel.tp import on_device
from ..utils.host_copy import finish_host_copy, host_to_device, start_host_copy, to_pcm16
from ..utils.metrics import metrics
from . import graphs
from .buckets import pad_to, pick_bucket
from .synthesizers import V2, pad_rows, sovits_warmup_units, synthesizer

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CharacterModel:
    """Loaded weights for one character (t2s + sovits, and the prompt
    encoder of a V2ProPlus one) on one device. A V4 character's
    ``sovits_params`` hold its whole synthesizer (V2's text side, the
    bridge, ``wns1``, the DiT under ``cfm`` and the 48 kHz vocoder under
    ``dec``) and ``v4_cfg`` its mel side (``models/sovits_v4.py``).
    ``synth`` is the version's object (``runtime/synthesizers.py``).

    On a serving mesh (``TTSEngine.replicate_character`` /
    ``shard_character``) ``replicas`` holds one CharacterModel per dp row,
    on that row's devices, and the fields above are replica 0's;
    ``placement`` is (the mesh, whether the T2S layers are tp-sharded)."""
    name: str
    language: str
    version: str                    # "v2" | "v2ProPlus" | "v4"
    t2s_params: Dict
    sovits_params: Dict
    t2s_cfg: T2SConfig
    sovits_cfg: SoVITSConfig
    device: torch.device = torch.device("cpu")
    prompt_encoder_params: Optional[Dict] = None
    replicas: Optional[List["CharacterModel"]] = None
    placement: Optional[tuple] = None
    v4_cfg: Optional[V4Config] = None

    @property
    def synth(self) -> V2:
        return synthesizer(self.version)

    @property
    def sample_rate(self) -> int:
        """The rate of the audio the character's synthesizer makes."""
        return self.synth.sample_rate(self)


@dataclasses.dataclass
class ReferenceFeatures:
    """Per-reference-clip features."""
    phones: np.ndarray              # [Tr] int32 phoneme ids of the transcript
    bert: np.ndarray                # [Tr, 1024] fp32
    prompt_tokens: np.ndarray       # [Tp] int32 semantic VQ tokens
    ge: np.ndarray                  # [gin, 1] speaker embedding (flow/dec)
    ge_mrte: np.ndarray             # [512, 1] speaker embedding (MRTE)
    # V4: the CFM's prompt, on the character's device: the clip's
    # normalised mel [P, mel_dim] and the prompt codes' mel-rate features
    # [P, 512], cut to their common length (at most V4Config.T_ref)
    mel2: Optional[torch.Tensor] = None
    fea_ref: Optional[torch.Tensor] = None


def _fit_codes(codes: torch.Tensor, bucket: int) -> torch.Tensor:
    if bucket < codes.shape[1]:
        return codes[:, :bucket]
    if bucket > codes.shape[1]:
        return torch.nn.functional.pad(codes, (0, bucket - codes.shape[1]))
    return codes


class _Stages:
    """Wall time of the pipeline's stages; with ``on``, each mark waits for
    the device first (span ``stage_sync``), so a stage's time is its own.
    While metrics record, each stage is a span ``solo_<stage>`` on the
    calling thread, whether or not ``on``."""

    def __init__(self, on: bool, device: torch.device):
        self.on, self.device = on, device
        self.times: Dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        if not (self.on or metrics.recording):
            return
        if self.on and self.device.type == "cuda":
            with metrics.span("stage_sync"):
                torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self.on:
            self.times[name] = self.times.get(name, 0.0) + now - self._t
        if metrics.recording:
            metrics.span_on_thread("solo_" + name, self._t, now)
        self._t = now


def _t2s_and_vocode(t2s_params, sovits_params, tcfg, vcfg, scfg, generator,
                    phones, bert, x_len, prompts, p_len, text, t_len, ge,
                    ge_mrte, noise_scale, max_steps, cache_len, min_steps,
                    codes_bucket=None, pcm16=False, max_steps_dyn=None,
                    vocode_chunk=0, vocode_halo=0, stages=None, stats=None):
    """Whole utterance: T2S decode + SoVITS vocode, no host read between
    them, every stage a program of ``runtime/graphs.py`` (the JAX
    package's one ``_fused`` program). ``codes_bucket`` sizes the vocoder
    stage (default ``max_steps``); padded frames are masked and the
    caller trims to ``2 * codes_len * hop`` samples. The chunked vocode
    skips the windows past the decode's step counter, which the host
    read."""
    stats = {} if stats is None else stats
    with metrics.device_span("solo_decode_device", phones.device) as span:
        codes, codes_len = t2s.generate_e2e(
            t2s_params, tcfg, scfg, generator, phones, bert, x_len, prompts, p_len,
            max_steps=max_steps, cache_len=cache_len, min_steps=min_steps,
            max_steps_dyn=max_steps_dyn, stats=stats)
        if metrics.recording:
            span.set(steps=stats["decode_steps"])
    if stages is not None:
        stages.mark("decode")
    codes = _fit_codes(codes, codes_bucket or max_steps)
    z = sovits.latent(sovits_params, vcfg, codes, codes_len, text, t_len, ge, ge_mrte,
                      noise_scale, generator=generator)
    if stages is not None:
        stages.mark("latent")
    if vocode_chunk:
        audio = sovits.vocode_frames_chunked(sovits_params, vcfg, z, ge, 2 * codes_len,
                                             chunk=vocode_chunk, halo=vocode_halo,
                                             bound=2 * (stats["decode_steps"] + 1))
    else:
        audio = sovits.vocode(sovits_params, vcfg, z, ge, 2 * codes_len)
    if stages is not None:
        stages.mark("vocode")
    if pcm16:
        audio = to_pcm16(audio)
    return audio, codes_len


def _t2s_latent_first(t2s_params, sovits_params, tcfg, vcfg, scfg, generator,
                      phones, bert, x_len, prompts, p_len, text, t_len, ge,
                      ge_mrte, noise_scale, max_steps, cache_len, min_steps,
                      codes_bucket, first_window, first_frames, pcm16=False,
                      max_steps_dyn=None, stats=None):
    """Streaming head: decode + latent + the FIRST vocode window, with no
    host read between them (programs of ``runtime/graphs.py``). Returns
    (z [B, 2*codes_bucket, C], which stays on the device for the
    remaining chunks, codes_len [B], the first audio [B,
    first_frames*hop])."""
    codes, codes_len = t2s.generate_e2e(
        t2s_params, tcfg, scfg, generator, phones, bert, x_len, prompts, p_len,
        max_steps=max_steps, cache_len=cache_len, min_steps=min_steps,
        max_steps_dyn=max_steps_dyn, stats=stats)
    codes = _fit_codes(codes, codes_bucket)
    z = sovits.latent(sovits_params, vcfg, codes, codes_len, text, t_len, ge, ge_mrte,
                      noise_scale, generator=generator)
    zc = z[:, :min(first_window, z.shape[1])]
    valid = torch.clamp(2 * codes_len, 0, zc.shape[1])
    a = sovits.vocode(sovits_params, vcfg, zc, ge, valid)
    first = a[:, :min(first_frames * vcfg.hop_length, a.shape[1])]
    return z, codes_len, to_pcm16(first) if pcm16 else first


class TTSEngine:
    """Synthesis on a character's device, or over a serving mesh.

    ``timing``: record each utterance's stage times (decode, latent,
    vocode, host), synchronizing the device at every stage boundary, in
    ``last_stats``; off by default, since the waits cost time.

    ``mesh``: a ``parallel/mesh.py::ServingMesh``. Characters are placed on
    it by :meth:`replicate_character` or :meth:`shard_character`;
    ``synthesize_batch`` then splits the batch over the dp rows."""

    def __init__(self, runtime_cfg: Optional[RuntimeConfig] = None,
                 timing: bool = False, mesh=None):
        self.cfg = runtime_cfg or RuntimeConfig()
        self.timing = timing
        self.mesh = mesh
        self.last_stats: Dict = {}
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(0)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._slot_states: Dict[tuple, list] = {}
        # (configuration, prompt bucket) pairs swept (:meth:`sweep_key`)
        self.swept: set = set()

    def _next_seed(self) -> int:
        with self._lock:
            return int(self._rng.integers(0, 2 ** 31 - 1))

    def take_slot_state(self, char: CharacterModel, key: tuple, factory):
        """A persistent slot state of ``char``'s configuration at the slot
        geometry ``key`` for the caller alone: one a warmup sweep or an
        earlier user left (:meth:`offer_slot_state`), else a new one from
        ``factory()``. A slot machine keeps the state it takes for as long
        as it lives, a segmented stream for one request, so no two users
        ever decode in one state; the graphs of the geometry replay on the
        configuration's resident state, which holds one user's at a time
        (``models/slots.py``)."""
        k = (graphs.cache_for(char.t2s_params), key)
        with self._lock:
            pool = self._slot_states.get(k)
            state = pool.pop() if pool else None
        if state is not None:
            return state
        with torch.inference_mode(False):     # updated in place in any mode
            return dataclasses.replace(factory(), persistent=True)

    def offer_slot_state(self, char: CharacterModel, key: tuple, state) -> None:
        """Leave ``state`` (not in use) for a later :meth:`take_slot_state`
        of a character of ``char``'s configuration at ``key``; the pools
        live as long as the engine."""
        k = (graphs.cache_for(char.t2s_params), key)
        with self._lock:
            pool = self._slot_states.setdefault(k, [])
            if not any(s is state for s in pool):
                pool.append(state)

    # -- serving over a mesh ----------------------------------------------

    @property
    def _dp_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.dp

    def replicate_character(self, char: CharacterModel) -> CharacterModel:
        """Place a character's weights on the mesh, whole: one replica per
        dp row, on the row's first device (dp serving)."""
        return self._place(char, shard=False)

    def shard_character(self, char: CharacterModel) -> CharacterModel:
        """Tensor-parallel placement over the mesh's tp axis: in each dp
        row's replica the T2S decoder's per-layer matmuls are split
        Megatron-style over the row's tp devices (qkv and ffn1
        column-parallel over whole heads and ffn columns, out and ffn2
        row-parallel: ``parallel/mesh.py::shard_serving_params``); SoVITS,
        the prompt encoder and the rest of the T2S are whole on the row's
        first device. Every serving path (solo, batched, slots, streams)
        then decodes tp-sharded (``parallel/tp.py``). With tp == 1 this is
        :meth:`replicate_character`. Raises when ``num_heads`` or
        ``ffn_dim`` does not split over tp."""
        return self._place(char, shard=self.mesh is not None and self.mesh.tp > 1)

    def _place(self, char: CharacterModel, shard: bool) -> CharacterModel:
        mesh = self.mesh
        if mesh is None:
            return char
        if char.placement is not None:
            if char.placement == (mesh, shard):
                return char
            raise ValueError(f"character '{char.name}' is already placed on "
                             f"another mesh or layout; load it anew")
        tcfg = char.t2s_cfg
        if shard and (tcfg.num_heads % mesh.tp or tcfg.ffn_dim % mesh.tp):
            raise ValueError(f"tp={mesh.tp} does not split the T2S decoder's "
                             f"{tcfg.num_heads} heads and ffn_dim {tcfg.ffn_dim}")
        reps = []
        for r, row in enumerate(mesh.devices):
            # every replica past the first holds weights of its own, on a
            # mesh that repeats a card too, and is marked with its row: the
            # rows decode at once, so each has graphs and a bank of its own
            # (``runtime/graphs.py::signature``), as on distinct cards
            lead, own = row[0], r > 0
            rep = dataclasses.replace(
                char, device=lead, replicas=None, placement=(mesh, shard),
                t2s_params=shard_serving_params(char.t2s_params,
                                                row if shard else row[:1], copy=own),
                sovits_params=place_tree(char.sovits_params, lead, own),
                prompt_encoder_params=(
                    None if char.prompt_encoder_params is None
                    else place_tree(char.prompt_encoder_params, lead, own)))
            if own:
                rep.t2s_params[graphs.DP_ROW] = rep.sovits_params[graphs.DP_ROW] = r
            reps.append(rep)
        r0 = reps[0]
        char.t2s_params, char.sovits_params = r0.t2s_params, r0.sovits_params
        char.prompt_encoder_params, char.device = r0.prompt_encoder_params, r0.device
        char.replicas, char.placement = reps, (mesh, shard)
        return char

    def _replicas(self, char: CharacterModel) -> List[CharacterModel]:
        """The character's replica per dp row ([char] with no mesh)."""
        if self.mesh is None:
            return [char]
        if char.placement is None or char.placement[0] != self.mesh:
            raise ValueError(f"character '{char.name}' is not placed on this "
                             f"engine's mesh: call shard_character (or "
                             f"replicate_character) first")
        return char.replicas

    def batch_rows(self, B: int) -> Tuple[int, int]:
        """(padded batch, rows per dp row) of a window batch of ``B`` rows:
        ``B`` padded to a ``batch_buckets`` size, then to a multiple of dp,
        and split evenly over the dp rows (:meth:`synthesize_batch`)."""
        dp = self._dp_size
        B_pad = max(pick_bucket(B, self.cfg.batch_buckets), B)
        B_pad = -(-B_pad // dp) * dp
        return B_pad, B_pad // dp

    def graph_caches(self, char: CharacterModel) -> list:
        """The graph caches of every replica of ``char``: each replica's
        T2S and SoVITS configurations (``runtime/graphs.py``), shared by
        every character of the same configuration."""
        return [graphs.cache_for(p) for rep in self._replicas(char)
                for p in (rep.t2s_params, rep.sovits_params)]

    def _rows_map(self, fn, reps: List[CharacterModel]) -> list:
        """``fn(r)`` for each dp row ``r``, each with its replica's device
        current and in inference mode: inline for one row, else on a pool
        of dp threads (so that each row's host work can overlap the
        others' device work). Results in row order; an error in any row raises."""
        def run(r):
            with torch.inference_mode(), on_device(reps[r].device):
                return fn(r)

        if len(reps) == 1:
            return [run(0)]
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(len(reps), thread_name_prefix="genie-dp")
        return list(self._pool.map(run, range(len(reps))))

    # -- reference feature extraction ------------------------------------

    @torch.inference_mode()
    def compute_prompt_tokens(self, char: CharacterModel,
                              ssl_content: np.ndarray) -> np.ndarray:
        """HuBERT features [T,768] -> semantic prompt ids [T//2]."""
        ssl = torch.as_tensor(np.asarray(ssl_content, np.float32),
                              device=char.device)[None]
        toks = t2s.extract_prompt_tokens(char.t2s_params, ssl)
        return toks[0].cpu().numpy().astype(np.int32)

    # -- synthesis --------------------------------------------------------

    def _solo_inputs(self, char: CharacterModel, ref: ReferenceFeatures,
                     text_phones: np.ndarray, text_bert: np.ndarray):
        """One sentence's device inputs at the solo bucket ladders: (T2S
        args, vocoder args, x_bucket + p_bucket). The packed [ref_text |
        text] and the prompts are truncated past their largest bucket and
        their lengths clamped, so unwritten cache positions stay out of
        the attention masks."""
        dev = char.device

        def ids(a, n):
            return torch.as_tensor(pad_to(np.asarray(a, np.int64), n), device=dev)[None]

        phones = np.concatenate([ref.phones, text_phones]).astype(np.int64)
        x_bucket = pick_bucket(len(phones), self.cfg.phoneme_buckets)
        p_bucket = pick_bucket(len(ref.prompt_tokens), self.cfg.prompt_buckets)
        if np.any(ref.bert) or np.any(text_bert):
            bert = np.concatenate([ref.bert, text_bert]).astype(np.float32)
            bert_dev = torch.as_tensor(pad_to(bert, x_bucket, axis=0), device=dev)[None]
        else:
            bert_dev = None  # all-zero BERT (the JA path)
        t_bucket = pick_bucket(len(text_phones), self.cfg.phoneme_buckets)
        args = dict(phones=ids(phones, x_bucket), bert=bert_dev,
                    x_len=torch.tensor([min(len(phones), x_bucket)], device=dev),
                    prompts=ids(ref.prompt_tokens, p_bucket),
                    p_len=torch.tensor([min(len(ref.prompt_tokens), p_bucket)],
                                       device=dev))
        tail = dict(text=ids(text_phones, t_bucket),
                    t_len=torch.tensor([min(len(text_phones), t_bucket)], device=dev),
                    ge=torch.as_tensor(ref.ge, device=dev)[None].float(),
                    ge_mrte=torch.as_tensor(ref.ge_mrte, device=dev)[None].float())
        return args, tail, x_bucket + p_bucket

    @torch.inference_mode()
    def synthesize_utterance(self, char: CharacterModel, ref: ReferenceFeatures,
                             text_phones: np.ndarray, text_bert: np.ndarray,
                             sampling: Optional[SamplingConfig] = None,
                             seed: Optional[int] = None,
                             noise_scale: float = 0.5,
                             fixed_steps: Optional[int] = None,
                             min_steps: int = 0,
                             max_steps: Optional[int] = None,
                             pcm16: bool = False,
                             cfm_seed: Optional[int] = None) -> np.ndarray:
        """One sentence -> waveform [S] at the character's rate (32 kHz;
        V4 48 kHz), float32, or int16 with ``pcm16``.

        A version that does not vocode in line (``synth.inline`` False:
        V4) decodes, reads the codes, and runs them through the pooled
        finisher's tail alone (:meth:`vocode_codes_dispatch`; V4's CFM
        noise from ``cfm_seed``, default ``seed``).

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
        max_steps = fixed_steps or max_steps or tcfg.max_decode_steps
        args, tail, cache_pre = self._solo_inputs(char, ref, text_phones, text_bert)
        cap = (fixed_steps if fixed_steps is not None
               else pick_bucket(max_steps, self.cfg.step_caps))
        min_steps = fixed_steps if fixed_steps is not None else min_steps
        stages.mark("host")
        inline = char.synth.inline

        if inline and (fixed_steps is not None or cap <= self.cfg.solo_fused_max_codes):
            audio, codes_len = _t2s_and_vocode(
                char.t2s_params, char.sovits_params, tcfg, vcfg, scfg, gen,
                noise_scale=noise_scale, max_steps=cap,
                cache_len=cache_pre + cap, min_steps=min_steps,
                max_steps_dyn=max_steps, codes_bucket=cap,
                vocode_chunk=self.cfg.vocode_chunk,
                vocode_halo=self.cfg.vocode_halo, pcm16=pcm16,
                stages=stages, stats=stats, **args, **tail)
            n_codes = int(codes_len[0])
            out = audio[0, :2 * n_codes * vcfg.hop_length].cpu().numpy()
        else:
            with metrics.device_span("solo_decode_device", dev) as span:
                codes, codes_len = t2s.generate_e2e(
                    char.t2s_params, tcfg, scfg, gen, max_steps=cap,
                    cache_len=cache_pre + cap, min_steps=min_steps,
                    max_steps_dyn=max_steps, stats=stats, **args)
                if metrics.recording:
                    span.set(steps=stats["decode_steps"])
            stages.mark("decode")
            n_codes = int(codes_len[0])
            if n_codes == 0:
                logger.warning("T2S produced no semantic tokens; returning silence")
                return np.zeros(0, np.int16 if pcm16 else np.float32)
            if not inline:
                out = self.vocode_codes_fetch(self.vocode_codes_dispatch(
                    char, [(ref, text_phones, codes[0, :n_codes].cpu().numpy())], pcm16=pcm16,
                    b_buckets=(1,), cfm_seeds=[seed if cfm_seed is None else cfm_seed]))[0]
                stages.mark("vocode")
            else:
                codes = _fit_codes(codes, pick_bucket(n_codes, self.cfg.frame_buckets))
                z = sovits.latent(char.sovits_params, vcfg, codes, codes_len, *tail.values(),
                                  noise_scale, generator=gen)
                stages.mark("latent")
                audio = sovits.vocode_frames_chunked(
                    char.sovits_params, vcfg, z, tail["ge"], 2 * codes_len,
                    chunk=self.cfg.vocode_chunk, halo=self.cfg.vocode_halo, bound=2 * n_codes)
                stages.mark("vocode")
                audio = audio[0, :2 * n_codes * vcfg.hop_length]
                out = (to_pcm16(audio) if pcm16 else audio).cpu().numpy()
        stages.mark("host")
        self.last_stats = {"codes_len": n_codes, **stats, "stages": stages.times}
        return out if pcm16 else out.astype(np.float32)

    # -- batched codes -> waveform tail (the slot finisher) ----------------

    def vocode_codes_batch(self, char: CharacterModel, items, seed: int = 0,
                           noise_scale: float = 0.5, b_buckets=None,
                           t_buckets=None, pcm16: bool = False, noise=None,
                           cfm_seeds=None):
        """Batched codes -> waveform tail (dispatch + fetch in one call)."""
        return self.vocode_codes_fetch(self.vocode_codes_dispatch(
            char, items, seed=seed, noise_scale=noise_scale, b_buckets=b_buckets,
            t_buckets=t_buckets, pcm16=pcm16, noise=noise, cfm_seeds=cfm_seeds))

    @torch.inference_mode()
    def vocode_codes_dispatch(self, char: CharacterModel, items, seed: int = 0,
                              noise_scale: float = 0.5, b_buckets=None,
                              t_buckets=None, pcm16: bool = False, noise=None,
                              cfm_seeds=None):
        """Device half of the batched tail: ``items`` = [(ref, text_phones,
        codes)] vocode as ONE batch, padded to ``b_buckets`` (default
        ``batch_buckets``) with copies of the first row, codes to a
        ``frame_buckets`` bucket and text to one ``t_buckets`` bucket
        (``synthesizers.pad_rows``), through the version's tail
        (``synth.tail``: graph replays on the card), PCM16 made on the
        device when ``pcm16``. The waveform's copy to host memory is
        enqueued right behind it; the returned handle goes to
        :meth:`vocode_codes_fetch`, which may run on any thread.

        V2's flow noise is drawn from a generator seeded with ``seed``, or
        given as ``noise`` [len(items), F, 192]; V4's CFM noise of each row
        from its entry of ``cfm_seeds`` (None: a seed of the engine's)."""
        B = len(items)
        lens = np.array([len(c) for (_, _, c) in items], np.int64)
        if B == 0 or int(lens.max()) == 0:
            empty = torch.zeros((B, 0), dtype=torch.int16 if pcm16 else torch.float32)
            return (empty, None), lens, 0, None
        synth = char.synth
        rows = pad_rows(items, max(pick_bucket(B, b_buckets or self.cfg.batch_buckets), B),
                        self.cfg.frame_buckets, t_buckets or self.cfg.phoneme_buckets)
        audio, events = synth.tail(self, char, rows, seed=seed, noise_scale=noise_scale,
                                   noise=noise, cfm_seeds=cfm_seeds)
        audio = to_pcm16(audio) if pcm16 else audio.float()
        metrics.incr("utterances", B)
        return start_host_copy(audio), rows.lens[:B], synth.samples_per_code(char), events

    def vocode_codes_fetch(self, handle):
        """Host half: wait for the waveform's copy and trim each row to its
        codes times the samples a code makes. Runs no device work; a V4
        batch's CFM launches, done by then, feed the timer ``cfm_device``."""
        copy, lens, per_code, events = handle
        audio = finish_host_copy(copy)
        for start, end in events or ():
            metrics.observe("cfm_device", start.elapsed_time(end) * 1e-3)
        return [audio[i, : int(lens[i]) * per_code] for i in range(len(lens))]

    # -- per-row window vocode (the slot batcher's window pump) -----------

    @torch.inference_mode()
    def vocode_windows_dispatch(self, char: CharacterModel, rows, win: int,
                                pcm16: bool = False, noise_scale: float = 0.5,
                                t_buckets=None, codes_dev=None):
        """Device half of a per-row WINDOW vocode.

        ``rows``: ``(ref, text_phones, codes_np, count, noise, start_frame,
        out_frames)``: vocode ``out_frames`` frames of the row's audio from
        latent frame ``start_frame`` on, out of the prefix latent over
        ``codes_np[:count]``. ``noise`` is the request's flow-noise table
        [N, 192] on the device (N >= 2 * the frame bucket), so a frame sees
        the same noise in every pump. Rows at different emit positions
        batch into one latent and one window vocode; the waveform's copy to
        host memory is enqueued behind them and the handle goes to
        :meth:`vocode_windows_fetch`. ``codes_dev``: [B_pad, fb] device
        codes that replace the rows' ``codes_np`` (the speculative first
        piece, read from a segment the host has not fetched)."""
        vcfg = char.sovits_cfg
        dev = char.device
        halo = self.cfg.vocode_halo
        B = len(rows)
        B_pad = max(pick_bucket(B, self.cfg.batch_buckets), B)
        rows = list(rows) + [rows[0]] * (B_pad - B)
        lens = np.array([r[3] for r in rows], np.int64)
        # fb >= win/2 so the window always fits the latent grid
        fb = pick_bucket(max(int(lens.max()), -(-win // 2)), self.cfg.frame_buckets)
        if int(lens.max()) > fb:
            raise ValueError(
                f"window vocode row has {int(lens.max())} latent frames > largest "
                f"frame bucket {fb}; raise frame_buckets or lower slot_ring/max_steps")
        if codes_dev is not None:
            if tuple(codes_dev.shape) != (B_pad, fb):
                raise ValueError(f"codes_dev shape {tuple(codes_dev.shape)} != "
                                 f"({B_pad}, {fb}): pad device codes to this "
                                 f"method's batch and frame buckets")
            codes_b = codes_dev.long()
        else:
            codes_b = host_to_device(np.stack([
                pad_to(np.clip(np.asarray(r[2][:fb], np.int64), 0, vcfg.vq_codes - 1), fb)
                for r in rows]), dev)
        t_lens = np.array([len(r[1]) for r in rows], np.int64)
        t_bucket = pick_bucket(int(t_lens.max()), t_buckets or self.cfg.phoneme_buckets)
        t_lens = np.minimum(t_lens, t_bucket)
        text_b = np.stack([pad_to(np.asarray(r[1], np.int64), t_bucket) for r in rows])
        ge = host_to_device(np.stack([r[0].ge for r in rows]).astype(np.float32), dev)
        gm = host_to_device(np.stack([r[0].ge_mrte for r in rows]).astype(np.float32), dev)
        # each row's noise table, read from its start (synthesize_latent_rows)
        z = sovits.latent(
            char.sovits_params, vcfg, codes_b, host_to_device(lens, dev),
            host_to_device(text_b, dev), host_to_device(t_lens, dev), ge, gm,
            noise_scale, noise=torch.stack([r[4] for r in rows]))
        F = 2 * fb
        win = min(win, F)          # tiny ladders: the window covers the grid
        starts = np.array([r[5] for r in rows], np.int64)
        s0 = np.clip(starts - halo, 0, F - win)
        audio = sovits.vocode_rows(char.sovits_params, vcfg, z, ge, host_to_device(s0, dev),
                                   host_to_device(2 * lens, dev), win)
        audio = to_pcm16(audio) if pcm16 else audio.float()
        hop = vcfg.hop_length
        widths = np.array([r[6] for r in rows], np.int64) * hop
        return start_host_copy(audio), (starts - s0) * hop, widths, B

    @staticmethod
    def vocode_windows_fetch(handle):
        """Host half of the window vocode: wait for the copy and cut each
        row's piece out of its window. Runs no device work."""
        copy, offs, widths, B = handle
        a = finish_host_copy(copy)
        return [a[i, offs[i]: offs[i] + widths[i]] for i in range(B)]

    # -- streaming ---------------------------------------------------------

    @torch.inference_mode()
    def synthesize_utterance_stream(self, char: CharacterModel,
                                    ref: ReferenceFeatures,
                                    text_phones: np.ndarray, text_bert: np.ndarray,
                                    sampling: Optional[SamplingConfig] = None,
                                    seed: Optional[int] = None,
                                    noise_scale: float = 0.5, min_steps: int = 0,
                                    max_steps: Optional[int] = None,
                                    pcm16: bool = False):
        """Generator of waveform chunks for one sentence.

        With ``stream_segmented`` (the default), a sentence that fits the
        stream geometry takes the segmented route (``runtime/stream.py``:
        the first chunk after one decode segment, whatever the length).
        Otherwise the fused head: decode (one fused kernel launch per step)
        + latent + the FIRST small vocode window, then one host read; the
        remaining ``vocode_chunk`` windows are all dispatched before the
        first of them is read. A version that does not stream (V4) raises
        ``NotImplementedError``."""
        char.synth.check_streams(char)
        if self.cfg.stream_segmented:
            from .stream import fits_stream, synthesize_stream_segments

            if fits_stream(self.cfg, ref, text_phones):
                yield from synthesize_stream_segments(
                    self, char, ref, text_phones, text_bert, sampling=sampling,
                    seed=seed, noise_scale=noise_scale, min_steps=min_steps,
                    max_steps=max_steps, pcm16=pcm16)
                return
        t_start = time.perf_counter()
        scfg = sampling or SamplingConfig()
        tcfg, vcfg = char.t2s_cfg, char.sovits_cfg
        if seed is None:
            seed = self._next_seed()
        gen = torch.Generator(device=char.device).manual_seed(int(seed))
        max_steps = max_steps or tcfg.max_decode_steps
        args, tail, cache_pre = self._solo_inputs(char, ref, text_phones, text_bert)
        hop = vcfg.hop_length
        chunk, halo = self.cfg.vocode_chunk, self.cfg.vocode_halo
        first = min(self.cfg.stream_first_chunk, chunk)
        cap = pick_bucket(max_steps, self.cfg.step_caps)
        F = 2 * cap
        stats: Dict = {}
        z, codes_len, first_audio = _t2s_latent_first(
            char.t2s_params, char.sovits_params, tcfg, vcfg, scfg, gen,
            noise_scale=noise_scale, max_steps=cap, cache_len=cache_pre + cap,
            min_steps=min_steps, max_steps_dyn=max_steps, codes_bucket=cap,
            first_window=min(first + halo, F), first_frames=first, pcm16=pcm16,
            stats=stats, **args, **tail)
        n_codes = int(codes_len[0])
        self.last_stats = {"codes_len": n_codes, **stats}
        if n_codes == 0:
            return
        total_valid = 2 * n_codes
        emitted = min(first, total_valid)
        first_np = first_audio[0, :emitted * hop].cpu().numpy()
        metrics.observe("ttfa", time.perf_counter() - t_start)
        yield first_np

        # the remaining chunks over the valid frames: all dispatched (and
        # their host copies enqueued) before the first is read; one window
        # width (one vocode graph), placed inside the latent's frames
        jobs = []
        win = min(chunk + 2 * halo, F)
        for start in range(first, total_valid, chunk):
            s0 = min(max(start - halo, 0), F - win)
            valid = torch.tensor([min(max(total_valid - s0, 0), win)], device=char.device)
            a = sovits.vocode(char.sovits_params, vcfg, z[:, s0:s0 + win], tail["ge"], valid)
            n_frames = min(chunk, total_valid - start)
            a = a[0, (start - s0) * hop:(start - s0 + n_frames) * hop]
            jobs.append((start_host_copy(to_pcm16(a) if pcm16 else a), n_frames))
        for copy, n_frames in jobs:
            emitted += n_frames
            yield finish_host_copy(copy)
        metrics.incr("utterances")
        metrics.observe("synthesize_utterance", time.perf_counter() - t_start)
        metrics.gauge("audio_seconds", emitted * hop / vcfg.sample_rate)

    # -- several utterances --------------------------------------------------

    @torch.inference_mode()
    def synthesize_pipelined(self, char: CharacterModel, ref: ReferenceFeatures,
                             items, sampling: Optional[SamplingConfig] = None,
                             seed: int = 0, noise_scale: float = 0.5,
                             fixed_steps: Optional[int] = None, window: int = 4):
        """Sequential utterances ``items`` = [(text_phones, text_bert)],
        each through the fused branch with seed ``seed + i``; each
        waveform's host copy is enqueued behind it and read with up to
        ``window`` utterances in flight. Returns float32 waveforms."""
        scfg = sampling or SamplingConfig()
        tcfg, vcfg = char.t2s_cfg, char.sovits_cfg
        max_steps = fixed_steps or tcfg.max_decode_steps
        cap = (fixed_steps if fixed_steps is not None
               else pick_bucket(max_steps, self.cfg.step_caps))
        in_flight, out = [], []

        def fetch_one():
            copy, n = in_flight.pop(0)
            a = finish_host_copy(copy)
            out.append(a[0, : 2 * int(finish_host_copy(n)[0]) * vcfg.hop_length]
                       .astype(np.float32))

        for i, (text_phones, text_bert) in enumerate(items):
            args, tail, cache_pre = self._solo_inputs(char, ref, text_phones, text_bert)
            gen = torch.Generator(device=char.device).manual_seed(int(seed) + i)
            audio, codes_len = _t2s_and_vocode(
                char.t2s_params, char.sovits_params, tcfg, vcfg, scfg, gen,
                noise_scale=noise_scale, max_steps=cap, cache_len=cache_pre + cap,
                min_steps=fixed_steps or 0, max_steps_dyn=max_steps,
                codes_bucket=cap, vocode_chunk=self.cfg.vocode_chunk,
                vocode_halo=self.cfg.vocode_halo, **args, **tail)
            in_flight.append((start_host_copy(audio), start_host_copy(codes_len)))
            if len(in_flight) >= window:
                fetch_one()
        while in_flight:
            fetch_one()
        return out

    @torch.inference_mode()
    def synthesize_batch(self, char: CharacterModel, items,
                         sampling: Optional[SamplingConfig] = None,
                         seed: Optional[int] = None, noise_scale: float = 0.5,
                         fixed_steps: Optional[int] = None, min_steps: int = 0,
                         max_steps: Optional[int] = None,
                         stats: Optional[Dict] = None):
        """Batched synthesis for the window batcher.

        ``items``: [(ref, text_phones, text_bert)]; rows of other lengths
        batch together through per-row masks. The batch is padded to a
        ``batch_buckets`` size with copies of the first row (and on a mesh
        to a multiple of dp), so a batch of B >= 2 decodes through
        ``generate``'s B > 1 route (the flash kernel in every layer of every
        step). One ``generate_e2e``, one read of the emitted lengths, one
        latent over a frame bucket of the longest row and a chunked
        HiFi-GAN, for each dp row's block of the batch on its replica. The
        Gumbel table and the flow noise are drawn once for the whole padded
        batch and split by rows, so a row's result does not depend on dp.
        ``stats`` receives ``decode_steps`` (the most of any dp row) and
        ``cache_len``. Returns float32 waveforms."""
        scfg = sampling or SamplingConfig()
        tcfg, vcfg = char.t2s_cfg, char.sovits_cfg
        reps = self._replicas(char)
        dp = self._dp_size
        dev = char.device
        if seed is None:
            seed = self._next_seed()
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        B = len(items)
        B_pad, n = self.batch_rows(B)
        items = list(items) + [items[0]] * (B_pad - B)
        phones_rows = [np.concatenate([r.phones, tp]).astype(np.int64)
                       for r, tp, _ in items]
        any_bert = any(bool(np.any(r.bert)) or bool(np.any(tb)) for r, _, tb in items)
        x_lens = np.array([len(p) for p in phones_rows], np.int64)
        p_lens = np.array([len(r.prompt_tokens) for r, _, _ in items], np.int64)
        t_lens = np.array([len(tp) for _, tp, _ in items], np.int64)
        x_bucket = pick_bucket(int(x_lens.max()), self.cfg.phoneme_buckets)
        p_bucket = pick_bucket(int(p_lens.max()), self.cfg.prompt_buckets)
        t_bucket = pick_bucket(int(t_lens.max()), self.cfg.phoneme_buckets)
        # rows past the largest bucket are truncated: clamp their lengths
        x_lens = np.minimum(x_lens, x_bucket)
        p_lens = np.minimum(p_lens, p_bucket)
        t_lens = np.minimum(t_lens, t_bucket)
        max_steps = fixed_steps or max_steps or tcfg.max_decode_steps
        cap = (fixed_steps if fixed_steps is not None
               else pick_bucket(max_steps, self.cfg.step_caps))
        phones_b = np.stack([pad_to(p, x_bucket) for p in phones_rows])
        bert_b = (np.stack([pad_to(np.concatenate([r.bert, tb]).astype(np.float32),
                                   x_bucket, axis=0) for r, _, tb in items])
                  if any_bert else None)
        prompts_b = np.stack([pad_to(np.asarray(r.prompt_tokens, np.int64), p_bucket)
                              for r, _, _ in items])
        text_b = np.stack([pad_to(np.asarray(tp, np.int64), t_bucket) for _, tp, _ in items])
        ge_b = np.stack([r.ge for r, _, _ in items]).astype(np.float32)
        gm_b = np.stack([r.ge_mrte for r, _, _ in items]).astype(np.float32)
        blocks = [slice(r * n, (r + 1) * n) for r in range(dp)]
        gumbel = gumbel_noise((cap, B_pad, tcfg.semantic_vocab), gen, dev)
        row_stats = [{} for _ in reps]

        def decode(r):
            rep, rows = reps[r], blocks[r]
            d = rep.device
            return t2s.generate_e2e(
                rep.t2s_params, tcfg, scfg, None, host_to_device(phones_b[rows], d),
                None if bert_b is None else host_to_device(bert_b[rows], d),
                host_to_device(x_lens[rows], d), host_to_device(prompts_b[rows], d),
                host_to_device(p_lens[rows], d), max_steps=cap,
                cache_len=x_bucket + p_bucket + cap, min_steps=fixed_steps or min_steps,
                max_steps_dyn=max_steps, stats=row_stats[r], noise=gumbel[:, rows].to(d))

        decoded = self._rows_map(decode, reps)
        lens = np.concatenate([codes_len.cpu().numpy() for _, codes_len in decoded])
        if stats is not None:
            stats.update(row_stats[0])
            stats["decode_steps"] = max(st["decode_steps"] for st in row_stats)
        if not char.synth.inline:
            # the finisher's tail over every row, on replica 0
            codes = torch.cat([c.to(dev) for c, _ in decoded]).cpu().numpy()
            rows = [(r, tp, codes[i, :int(lens[i])]) for i, (r, tp, _) in enumerate(items[:B])]
            return [a.astype(np.float32) for a in self.vocode_codes_fetch(
                self.vocode_codes_dispatch(char, rows, cfm_seeds=[int(seed) + i
                                                                  for i in range(B)]))]
        c_bucket = pick_bucket(int(max(lens.max(), 1)), self.cfg.frame_buckets)
        flow_noise = torch.randn((B_pad, 2 * c_bucket, vcfg.inter_channels),
                                 generator=gen, device=dev, dtype=torch.float32)

        def finish(r):
            rep, rows = reps[r], blocks[r]
            d = rep.device
            codes, codes_len = decoded[r]
            ge = host_to_device(ge_b[rows], d)
            z = sovits.latent(
                rep.sovits_params, vcfg, _fit_codes(codes, c_bucket), codes_len,
                host_to_device(text_b[rows], d), host_to_device(t_lens[rows], d), ge,
                host_to_device(gm_b[rows], d), noise_scale, noise=flow_noise[rows].to(d))
            return sovits.vocode_frames_chunked(
                rep.sovits_params, vcfg, z, ge, 2 * codes_len, chunk=self.cfg.vocode_chunk,
                halo=self.cfg.vocode_halo, bound=2 * int(lens[rows].max())).cpu().numpy()

        audio = np.concatenate(self._rows_map(finish, reps))
        metrics.incr("utterances", B)
        return [audio[i, : 2 * int(lens[i]) * vcfg.hop_length].astype(np.float32)
                for i in range(B)]


    # -- warmup ------------------------------------------------------------

    def _run_compile_units(self, units) -> int:
        """Run warmup thunks, one after another (a capture synchronizes the
        card, and the graphs of one parameter set share their cache).
        Returns the number of units run."""
        for u in units:
            u()
        return len(units)

    @torch.inference_mode()
    def warmup(self, char: CharacterModel, ref: ReferenceFeatures,
               sweep: bool = False) -> int:
        """Prepare the steady-state programs ahead of serving.

        ``sweep=False``: one synthesis (the smallest bucket combination).
        ``sweep=True``: capture every graph the serving path can hit
        (``runtime/graphs.py``) — solo ``generate`` per phoneme bucket at
        the reference's prompt bucket and the character's step cap (with
        and without BERT features: one decode graph; the fused stream head
        and the staged branch decode through it too), the window
        batcher's B > 1 decode per batch and phoneme bucket, each with its
        prefill program and both block lengths (``t2s.DECODE_BLOCKS``:
        every per-request cap replays them), with and without top-p; the
        SoVITS latent and vocode programs of the solo routes
        (:meth:`solo_warmup_units`) and of the window batcher
        (:meth:`finisher_warmup_units`); and (when slot serving is on)
        every slot join and segment program with the finisher's and
        window pump's SoVITS programs (:func:`slot_warmup_units`), (when
        segmented streaming is on) the stream's
        (:func:`stream_warmup_units`), and for a Chinese or hybrid
        character RoBERTa's feature program at every token bucket, once
        per device (``model_manager.roberta_warmup_units``; a character
        swept later finds them captured). A tp-sharded character's T2S
        programs are captured as a whole one's (route "tp").

        On a mesh every dp replica is swept for what its dp row can
        reach (each replica's graphs read its own weights): replica 0
        everything above, and the window batcher's per-row decode and
        finisher programs at the rows per dp row of every batch bucket
        (:meth:`batch_rows`, as :meth:`synthesize_batch` splits a batch);
        replicas 1 and up those per-row programs alone (every other path
        runs on replica 0). On the CPU nothing is captured: the keys,
        buffers and variants are recorded. Returns the number of units
        run; the caches' ``stats`` (:meth:`graph_caches`) count the
        graphs captured.

        The graphs are the configuration's (``runtime/graphs.py``: they
        read its bank, which every character of it binds), so a sweep
        warms every character of ``char``'s configuration at this prompt
        bucket, as the JAX package's one compile serves every character:
        a sweep of a configuration and bucket swept already
        (:meth:`sweep_key`, recorded in ``swept``) runs 0 units (RoBERTa's
        programs are swept once per device)."""
        if not sweep:
            phones = np.zeros(8, np.int32)
            bert = np.zeros((8, char.t2s_cfg.bert_dim), np.float32)
            self.synthesize_utterance(char, ref, phones, bert, seed=0)
            return 1
        cfg, tcfg = self.cfg, char.t2s_cfg
        if not self.needs_sweep(char, ref):
            return 0
        key = self.sweep_key(char, ref)
        roberta = self._roberta_key(char)
        reps = self._replicas(char)
        p_bucket = pick_bucket(len(ref.prompt_tokens), cfg.prompt_buckets)
        cap = pick_bucket(tcfg.max_decode_steps, cfg.step_caps)
        # the rows a dp row decodes and vocodes of each window batch bucket
        rows = ({self.batch_rows(b)[1] for b in cfg.batch_buckets}
                if cfg.serve_batching else set())

        def decode(params, B, xb):
            # every program of the geometry's graph captured on its zeroed
            # buffers, with the set bound (on the CPU: its key and variants
            # recorded)
            with graphs.cache_for(params).bind(params) as params:
                g, packed = t2s.decode_graph(params, tcfg, B, xb, p_bucket,
                                             xb + p_bucket + cap, cap,
                                             params["audio_embed"].dtype)
                with g.lock:
                    for variant, fn in t2s.generate_programs(params, tcfg, xb, p_bucket,
                                                             packed).items():
                        g.prepare(fn, variant)

        units = []
        if key not in self.swept:
            for r, rep in enumerate(reps):
                batch = set(rows)
                if r == 0:
                    batch |= {1} | ({b for b in cfg.batch_buckets if b > 1}
                                    if cfg.serve_batching else set())
                for B in sorted(batch):
                    for xb in cfg.phoneme_buckets:
                        units.append(functools.partial(decode, rep.t2s_params, B, xb))
            units += self.solo_warmup_units(char)
            if cfg.serve_batching:
                units += self.finisher_warmup_units(char,
                                                    b_buckets=set(cfg.batch_buckets) | rows)
                for rep in reps[1:]:
                    units += self.finisher_warmup_units(rep, b_buckets=rows)
            if cfg.serve_slots:
                from .slot_batcher import slot_warmup_units

                units.extend(slot_warmup_units(self, char))
            if cfg.stream_segmented and char.synth.streams:
                from .stream import stream_warmup_units

                units.extend(stream_warmup_units(self, char))
        if roberta is not None and roberta not in self.swept:
            from .model_manager import model_manager

            units.extend(model_manager.roberta_warmup_units(char.device))
        with metrics.timer("warmup_sweep"):
            n = self._run_compile_units(units)
        self.swept |= {key} | ({roberta} if roberta is not None else set())
        caches = self.graph_caches(char)
        logger.info("warmup sweep ran %d units over %d replica(s), %d + %d graphs captured "
                    "(T2S + SoVITS)", n, len(reps),
                    sum(c.stats["captures"] for c in caches[0::2]),
                    sum(c.stats["captures"] for c in caches[1::2]))
        return n

    def sweep_key(self, char: CharacterModel, ref: ReferenceFeatures) -> tuple:
        """What a sweep of ``char`` at ``ref`` warms: the configuration of
        each of its replicas (their graph caches), its model configs and
        the reference's prompt bucket."""
        return (tuple(self.graph_caches(char)), char.t2s_cfg, char.sovits_cfg,
                pick_bucket(len(ref.prompt_tokens), self.cfg.prompt_buckets))

    @staticmethod
    def _roberta_key(char: CharacterModel):
        """RoBERTa's sweep record on ``char``'s device, or None for a
        character whose language takes no BERT features."""
        if "Chinese" not in normalize_language(char.language):
            return None
        return ("roberta", char.device)

    def needs_sweep(self, char: CharacterModel, ref: ReferenceFeatures) -> bool:
        """Whether :meth:`warmup` with ``sweep=True`` has work to do: the
        configuration and prompt bucket, or RoBERTa's device, not swept."""
        roberta = self._roberta_key(char)
        return (self.sweep_key(char, ref) not in self.swept
                or (roberta is not None and roberta not in self.swept))

    def chunk_widths(self, F: int) -> set:
        """The window widths ``sovits.vocode_frames_chunked`` vocodes over
        ``F`` latent frames at the engine's ``vocode_chunk`` and halo."""
        chunk, halo = self.cfg.vocode_chunk, self.cfg.vocode_halo
        if not chunk or F <= chunk + 2 * halo:        # one whole-F pass
            return {F}
        return {s1 - s0 for _, s0, s1, _ in sovits.chunk_windows(F, chunk, halo)}

    def solo_warmup_units(self, char: CharacterModel) -> list:
        """Warmup thunks for the SoVITS programs of solo synthesis: the
        latent over the character's step cap (the fused branch and the
        fused stream head; every frame bucket too when the cap takes the
        staged branch) at every text bucket, the chunked vocode's windows
        over them, and the fused stream head's first and later windows. A
        version that does not vocode in line: its tail's units for one row
        at every text bucket."""
        cfg = self.cfg
        if not char.synth.inline:
            return char.synth.tail_warmup_units(self, char, (1,), cfg.phoneme_buckets)
        cap = pick_bucket(char.t2s_cfg.max_decode_steps, cfg.step_caps)
        frames = {cap} | (set(cfg.frame_buckets) if cap > cfg.solo_fused_max_codes else set())
        latents = {(1, fb, tb) for fb in frames for tb in cfg.phoneme_buckets}
        vocodes = {(1, w) for fb in frames for w in self.chunk_widths(2 * fb)}
        F, chunk, halo = 2 * cap, cfg.vocode_chunk, cfg.vocode_halo
        vocodes |= {(1, min(min(cfg.stream_first_chunk, chunk) + halo, F)),
                    (1, min(chunk + 2 * halo, F))}
        return sovits_warmup_units(char, latents, vocodes)

    def finisher_warmup_units(self, char: CharacterModel, t_buckets=None,
                              b_buckets=None) -> list:
        """Warmup thunks for the batched codes -> waveform tails
        (:meth:`vocode_codes_dispatch`, and :meth:`synthesize_batch`'s
        finish): the version's tail's (``synth.tail_warmup_units``) at
        every batch and text bucket they can hit.
        ``t_buckets`` narrows the text ladder (the slot batcher pins one
        text bucket); ``b_buckets`` replaces the batch ladder (a dp row's
        rows, :meth:`batch_rows`)."""
        cfg = self.cfg
        t_buckets = tuple(t_buckets or cfg.phoneme_buckets)
        b_buckets = sorted(cfg.batch_buckets if b_buckets is None else b_buckets)
        return char.synth.tail_warmup_units(self, char, b_buckets, t_buckets)

    def window_warmup_units(self, char: CharacterModel, wins, t_bucket: int) -> list:
        """Warmup thunks for the slot window pump
        (:meth:`vocode_windows_dispatch`): a capture of the per-row prefix
        latent at every (batch, frame) bucket a window of ``wins`` can
        take (frame >= win/2) and of the window's vocode there. None for
        a version that does not stream (it pumps no windows)."""
        cfg = self.cfg
        if not char.synth.streams:
            return []
        latents, vocodes = set(), set()
        for b in cfg.batch_buckets:
            for win in wins:
                fb_min = pick_bucket(-(-win // 2), cfg.frame_buckets)
                for fb in cfg.frame_buckets:
                    if fb >= fb_min:
                        latents.add((b, fb, t_bucket))
                        vocodes.add((b, min(win, 2 * fb)))
        return sovits_warmup_units(char, latents, vocodes)


# ---------------------------------------------------------------------------
# Random character factory (tests and the chip smoke run)
# ---------------------------------------------------------------------------

def make_random_character(name: str = "random", language: str = "Japanese",
                          seed: int = 0, t2s_cfg: Optional[T2SConfig] = None,
                          sovits_cfg: Optional[SoVITSConfig] = None,
                          dtype=torch.bfloat16, eos_boost: float = 1.0,
                          device=None, v4_cfg: Optional[V4Config] = None) -> CharacterModel:
    """Random-weight character, its synthesizer made by the version of
    ``sovits_cfg`` (``synth.init``): a V2ProPlus one (its
    ``gin_channels`` is the caller's: 1024 at full width) gets a random
    prompt encoder, and its synthesizer no style encoder, as a converted
    V2ProPlus checkpoint has. A V4 one (``version="v4"``) gets V4's
    synthesizer (``models/sovits_v4.py::init_params``) at ``v4_cfg``
    (default: the published widths).

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
        name=name, language=language, version=vcfg.version, t2s_params=t2s_params,
        t2s_cfg=tcfg, sovits_cfg=vcfg, device=dev,
        **synthesizer(vcfg.version).init(gen, vcfg, v4_cfg, dtype))


def make_random_reference(char: CharacterModel, engine: TTSEngine,
                          ref_seconds: float = 5.0, seed: int = 0) -> ReferenceFeatures:
    """Reference features from white-noise audio, stand-in HuBERT features
    at 50 Hz and a random 12-phoneme transcript (warmups and tests); the
    speaker conditioning is the version's (``synth.reference``), from a
    random SV embedding where the version clones from one."""
    synth = char.synth
    rng = np.random.default_rng(seed)
    sr = char.sovits_cfg.sample_rate
    audio_32k = (rng.standard_normal(int(ref_seconds * sr)) * 0.05).astype(np.float32)
    ssl = rng.standard_normal((int(ref_seconds * 50), char.t2s_cfg.ssl_dim)).astype(
        np.float32)
    sv_emb = (rng.standard_normal(char.sovits_cfg.sv_dim).astype(np.float32)
              if synth.needs_sv else None)
    phones = rng.integers(1, char.t2s_cfg.phoneme_vocab, 12).astype(np.int32)
    prompts = engine.compute_prompt_tokens(char, ssl)
    return ReferenceFeatures(
        phones=phones, bert=np.zeros((12, char.t2s_cfg.bert_dim), np.float32),
        prompt_tokens=prompts, **synth.reference(char, audio_32k, prompt_tokens=prompts,
                                                 phones=phones, sv_emb=sv_emb))
