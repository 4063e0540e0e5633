"""One object per GPT-SoVITS synthesizer version (``CharacterModel.synth``,
looked up in :data:`SYNTHESIZERS` by the character's ``version``; a version
outside the table is served as V2). It holds all that the versions differ
in, so the runtime tests no version itself: the rate and the samples a
code makes, how a synthesizer is built and loaded, what a reference clip
yields (:meth:`V2.reference`), the batched codes -> waveform tail
(:meth:`V2.tail`) and its warm-up units, whether the engine's solo and
window-batch routes vocode in line with the decode (``inline``), and
whether the version streams (``streams``).
"""
from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..config import SoVITSConfig, V4Config, config_from
from ..convert.io import load_params
from ..models import prompt_encoder, sovits, sovits_v4
from ..ops.audio import linear_spectrogram
from ..utils.host_copy import host_to_device
from .buckets import pad_to, pick_bucket


@dataclasses.dataclass
class Rows:
    """``B`` rows [(ref, text_phones, codes)] padded for a tail: ``items``
    with copies of the first up to B_pad, and their host arrays."""
    items: list
    B: int
    lens: np.ndarray            # [B_pad] codes per row
    codes: np.ndarray           # [B_pad, c_bucket]
    t_lens: np.ndarray          # [B_pad]
    text: np.ndarray            # [B_pad, t_bucket]
    ge: np.ndarray              # [B_pad, gin, 1] float32


def pad_rows(items, B_pad: int, frame_buckets, t_buckets) -> Rows:
    """``items`` padded to ``B_pad`` rows, codes to a ``frame_buckets``
    bucket and text to a ``t_buckets`` one (longer rows truncated)."""
    B = len(items)
    items = list(items) + [items[0]] * (B_pad - B)
    lens = np.array([len(c) for (_, _, c) in items], np.int64)
    c_bucket = pick_bucket(int(lens.max()), frame_buckets)
    lens = np.minimum(lens, c_bucket)
    codes = np.stack([pad_to(np.asarray(c[:c_bucket], np.int64), c_bucket)
                      for (_, _, c) in items])
    t_lens = np.array([len(tp) for (_, tp, _) in items], np.int64)
    t_bucket = pick_bucket(int(t_lens.max()), t_buckets)
    t_lens = np.minimum(t_lens, t_bucket)
    text = np.stack([pad_to(np.asarray(tp, np.int64), t_bucket) for (_, tp, _) in items])
    ge = np.stack([r.ge for (r, _, _) in items]).astype(np.float32)
    return Rows(items, B, lens, codes, t_lens, text, ge)


def sovits_warmup_units(char, latents, vocodes) -> list:
    """Warmup thunks capturing ``char``'s SoVITS latent programs at the
    (B, Ts, Tt) keys ``latents`` and vocode programs at the (B, W) keys
    ``vocodes`` (``models/sovits.py``; on the CPU the keys and buffers
    are made)."""
    p, v = char.sovits_params, char.sovits_cfg
    return ([functools.partial(sovits.prepare, p, v, "latent", k) for k in sorted(latents)]
            + [functools.partial(sovits.prepare, p, v, "vocode", k) for k in sorted(vocodes)])


def _clip(char, audio_32k):
    """The clip on the character's device [1, S], and its linear spectrogram."""
    cfg = char.sovits_cfg
    audio = torch.as_tensor(np.asarray(audio_32k, np.float32), device=char.device)[None]
    return audio, linear_spectrogram(audio, n_fft=cfg.n_fft, hop=cfg.hop_length,
                                     win_length=cfg.win_length)


class V2:
    """GPT-SoVITS V2: SoVITS's latent and the 32 kHz HiFi-GAN, conditioned
    on the style encoder's embedding of the reference clip."""
    # the engine's solo and window-batch routes run the latent and
    # HiFi-GAN in line with the decode, the flow noise from the decode's
    # generator; False sends their codes to :meth:`tail`
    inline = True
    streams = True
    needs_sv = False            # clones from a speaker-verification embedding
    files = ()                  # a character directory's files besides REQUIRED_FILES
    gin_channels = 512          # a loaded character's, unless config.json names it

    def sample_rate(self, char) -> int:
        return char.sovits_cfg.sample_rate

    def samples_per_code(self, char) -> int:
        return 2 * char.sovits_cfg.hop_length

    def cfm_seed(self, engine, seed: Optional[int]) -> Optional[int]:
        return seed             # a request's noise seed for :meth:`tail`: V2 draws none

    def check_streams(self, char) -> None:
        if not self.streams:
            v = type(self).__name__
            raise NotImplementedError(
                f"character '{char.name}' is GPT-SoVITS {v}: streaming routes (the segmented "
                f"stream, the fused stream head, slot streams and the window pump) do not "
                f"support {v} yet; use the non-streaming routes")

    def check_files(self, path: Path) -> None:
        missing = [f for f in self.files if not (path / f).is_file()]
        if missing:
            raise FileNotFoundError(
                f"{type(self).__name__} model at '{path}' missing: {', '.join(missing)}")

    def init(self, gen, vcfg: SoVITSConfig, v4_cfg: Optional[V4Config], dtype) -> Dict:
        """A random synthesizer's CharacterModel fields."""
        return {"sovits_params": sovits.init_params(gen, vcfg, dtype=dtype)}

    def load(self, path: Path, cfg: Dict, version: str, dtype, dev) -> Dict:
        """The CharacterModel fields of the synthesizer in the character
        directory ``path`` with config ``cfg``."""
        return {"sovits_cfg": config_from(SoVITSConfig, cfg.get("sovits"), version=version,
                                          gin_channels=self.gin_channels),
                "sovits_params": load_params(path / "vits.safetensors", dtype, dev)}

    @torch.inference_mode()
    def reference(self, char, audio_32k: np.ndarray, clip_samples: Optional[int] = None,
                  prompt_tokens=None, phones=None, sv_emb=None) -> Dict:
        """The clip's speaker conditioning as ReferenceFeatures fields:
        ``ge`` [gin, 1] from the style encoder, and ``ge_mrte``, its first
        ``mrte_channels`` rows. The clip's length without its appended
        silence, the prompt codes, the transcript's phonemes and the SV
        embedding serve the versions that read them."""
        ge = self._style(char, audio_32k)[1][0].cpu().numpy()
        return {"ge": ge, "ge_mrte": ge[: char.sovits_cfg.mrte_channels]}

    @staticmethod
    def _style(char, audio_32k):
        """(the clip [1, S] on the device, the style encoder's ``ge`` [1,
        gin, 1] float32 over the spectrogram bins it reads)."""
        audio, spec = _clip(char, audio_32k)
        spec = spec[..., :char.sovits_params["ref_enc"]["spectral0"]["w"].shape[0]]
        return audio, sovits.reference_embedding(
            char.sovits_params, char.sovits_cfg, spec,
            torch.tensor([spec.shape[1]], device=char.device)).float()

    def tail(self, engine, char, rows: Rows, seed: int = 0, noise_scale: float = 0.5,
             noise=None, cfm_seeds=None):
        """One latent program and the chunked HiFi-GAN's over the rows:
        (waveform [B, S] on the device, None). The flow noise is drawn from
        a generator seeded with ``seed``, or given as ``noise`` [B, F, 192]
        (frames beyond a row's codes are masked; F is cut or zero-padded to
        the frame bucket); ``cfm_seeds`` are ignored."""
        vcfg, dev, cfg = char.sovits_cfg, char.device, engine.cfg
        B, B_pad = rows.B, len(rows.items)
        lens_d = host_to_device(rows.lens, dev)
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=torch.float32)
            noise = torch.cat([noise, noise[:1].expand(B_pad - B, *noise.shape[1:])])
            F2 = 2 * rows.codes.shape[1]
            noise = (noise[:, :F2] if noise.shape[1] >= F2 else
                     torch.nn.functional.pad(noise, (0, 0, 0, F2 - noise.shape[1])))
            noise = host_to_device(noise, dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        ge = host_to_device(rows.ge, dev)
        gm = np.stack([r.ge_mrte for (r, _, _) in rows.items]).astype(np.float32)
        z = sovits.latent(
            char.sovits_params, vcfg, host_to_device(rows.codes, dev), lens_d,
            host_to_device(rows.text, dev), host_to_device(rows.t_lens, dev), ge,
            host_to_device(gm, dev), noise_scale, noise=noise, generator=gen)
        audio = sovits.vocode_frames_chunked(
            char.sovits_params, vcfg, z, ge, 2 * lens_d, chunk=cfg.vocode_chunk,
            halo=cfg.vocode_halo, bound=2 * int(rows.lens.max()))[:B]
        return audio, None

    def tail_warmup_units(self, engine, char, b_buckets, t_buckets) -> list:
        """Warmup thunks for :meth:`tail`: captures of the latent program at
        every (batch, frame, text) bucket and of the vocode program at every
        window of the chunked HiFi-GAN at every batch bucket."""
        cfg = engine.cfg
        latents = {(b, fb, tb) for b in b_buckets for fb in cfg.frame_buckets
                   for tb in t_buckets}
        vocodes = {(b, w) for b in b_buckets for fb in cfg.frame_buckets
                   for w in engine.chunk_widths(2 * fb)}
        return sovits_warmup_units(char, latents, vocodes)


class V2ProPlus(V2):
    """V2's synthesizer at gin 1024, conditioned by the prompt encoder over
    the clip's linear spectrogram and its speaker-verification embedding
    (a converted checkpoint has no style encoder)."""
    needs_sv = True
    files = ("prompt_encoder.safetensors",)
    gin_channels = 1024

    def init(self, gen, vcfg, v4_cfg, dtype) -> Dict:
        fields = super().init(gen, vcfg, v4_cfg, dtype)
        del fields["sovits_params"]["ref_enc"]
        fields["prompt_encoder_params"] = prompt_encoder.init_params(
            gen, vcfg, dtype=dtype, gin=vcfg.gin_channels, mrte_dim=vcfg.mrte_channels)
        return fields

    def load(self, path, cfg, version, dtype, dev) -> Dict:
        return {**super().load(path, cfg, version, dtype, dev),
                "prompt_encoder_params": load_params(path / "prompt_encoder.safetensors",
                                                     dtype, dev)}

    @torch.inference_mode()
    def reference(self, char, audio_32k, clip_samples=None, prompt_tokens=None, phones=None,
                  sv_emb=None) -> Dict:
        """(ge [gin, 1], ge_mrte [512, 1]) from the prompt encoder."""
        if sv_emb is None:
            raise RuntimeError("V2ProPlus cloning needs a speaker-verification "
                               "embedding; install the SV model into GenieData.")
        if char.prompt_encoder_params is None:
            raise RuntimeError(f"character '{char.name}' has no prompt encoder")
        dev = char.device
        _, spec = _clip(char, audio_32k)
        ge, ge_mrte = prompt_encoder.apply(
            char.prompt_encoder_params, spec, torch.tensor([spec.shape[1]], device=dev),
            torch.as_tensor(np.asarray(sv_emb, np.float32), device=dev)[None])
        return {"ge": ge[0].float().cpu().numpy(), "ge_mrte": ge_mrte[0].float().cpu().numpy()}


class V4(V2):
    """GPT-SoVITS V4 (``models/sovits_v4.py``): a DiT under conditional flow
    matching, its noise from a per-request seed, and a 48 kHz vocoder. Every
    route sends its codes to the pooled tail; none streams yet (the chunked
    CFM makes no audio before a whole chunk is sampled)."""
    inline = False
    streams = False

    def sample_rate(self, char) -> int:
        return char.v4_cfg.sample_rate

    def samples_per_code(self, char) -> int:
        return char.v4_cfg.samples_per_code

    def cfm_seed(self, engine, seed):
        return engine._next_seed() if seed is None else seed

    def init(self, gen, vcfg, v4_cfg, dtype) -> Dict:
        v4 = v4_cfg or V4Config()
        return {"sovits_params": sovits_v4.init_params(gen, vcfg, v4, dtype=dtype),
                "v4_cfg": v4}

    def load(self, path, cfg, version, dtype, dev) -> Dict:
        return {**super().load(path, cfg, version, dtype, dev),
                "v4_cfg": config_from(V4Config, cfg.get("v4"))}

    @torch.inference_mode()
    def reference(self, char, audio_32k, clip_samples=None, prompt_tokens=None, phones=None,
                  sv_emb=None) -> Dict:
        """V2's ``ge`` (its style encoder reads the first 704 bins) and
        ``ge_mrte``, and the CFM's prompt on the character's device:
        ``mel2``, the mel of the clip's first ``clip_samples`` samples
        (default: all), and ``fea_ref``, the prompt codes' ``decode_encp``
        with the transcript's phonemes, cut to their common length
        (``sovits_v4.prompt_features``).

        Computed once a clip, with cuDNN's convolutions in true float32
        (TF32 off while it runs, for every thread): ``ge`` conditions every
        request, and TF32's rounding in the style encoder's convolutions
        moved it by up to 1.6e-4 (relative) on the card."""
        cfg, v4, dev = char.sovits_cfg, char.v4_cfg, char.device
        clip_samples = len(audio_32k) if clip_samples is None else clip_samples
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            audio, ge = self._style(char, audio_32k)
            mel = sovits_v4.reference_mel(audio[0, :clip_samples], v4)
            codes = torch.as_tensor(np.asarray(prompt_tokens, np.int64), device=dev)[None]
            phones = torch.as_tensor(np.asarray(phones, np.int64), device=dev)[None]
            fea = sovits_v4.decode_encp(char.sovits_params, cfg, v4, codes,
                                        torch.tensor([codes.shape[1]], device=dev), phones,
                                        torch.tensor([phones.shape[1]], device=dev), ge)[0]
        mel2, fea_ref = sovits_v4.prompt_features(mel, fea.float(), v4)
        ge = ge[0].cpu().numpy()
        return {"ge": ge, "ge_mrte": ge[: cfg.mrte_channels], "mel2": mel2, "fea_ref": fea_ref}

    def tail(self, engine, char, rows, seed=0, noise_scale=0.5, noise=None, cfm_seeds=None):
        """``sovits_v4.synthesize_rows`` over the rows, each row's noise
        from its entry of ``cfm_seeds`` (None: a seed of the engine's):
        (waveform [B, S] on the device, the CFM launches' CUDA events)."""
        v4, dev, cfg = char.v4_cfg, char.device, engine.cfg
        B = rows.B
        seeds = [self.cfm_seed(engine, s)
                 for s in (cfm_seeds if cfm_seeds is not None else [None] * B)]
        events: list = []
        audio = sovits_v4.synthesize_rows(
            char.sovits_params, char.sovits_cfg, v4, host_to_device(rows.codes, dev),
            host_to_device(rows.lens, dev), host_to_device(rows.text, dev),
            host_to_device(rows.t_lens, dev), host_to_device(rows.ge, dev),
            [(r.fea_ref, r.mel2) for (r, _, _) in rows.items[:B]], seeds, rows.lens[:B],
            batch_buckets=cfg.batch_buckets, chunk=cfg.vocode_chunk, halo=cfg.vocode_halo,
            events=events)[:B]
        return audio, events

    def tail_warmup_units(self, engine, char, b_buckets, t_buckets) -> list:
        """Captures of ``decode_encp`` at every (batch, frame, text) bucket,
        of a chunk's CFM loop at every (rows, CFM frame bucket, steps), and
        of the vocoder at every window of the chunked pass and batch bucket."""
        cfg, v4, bs = engine.cfg, char.v4_cfg, sorted(b_buckets)

        def unit(kind, key):
            return functools.partial(sovits_v4.prepare, char.sovits_params, v4, kind, key,
                                     char.sovits_cfg)

        widths = sorted({w for fb in cfg.frame_buckets
                         for w in engine.chunk_widths(v4.frames_per_code * fb)})
        return ([unit("v4_encp", (b, fb, tb)) for b in bs for fb in cfg.frame_buckets
                 for tb in sorted(t_buckets)]
                + [unit("cfm", (r, T, v4.sample_steps)) for r in bs
                   for T in sovits_v4.cfm_buckets(v4)]
                + [unit("v4_vocode", (b, w)) for b in bs for w in widths])


SYNTHESIZERS: Dict[str, V2] = {"v2": V2(), "v2ProPlus": V2ProPlus(), "v4": V4()}


def synthesizer(version: str) -> V2:
    """The object of ``version``; V2's for a version outside the table."""
    return SYNTHESIZERS.get(version, SYNTHESIZERS["v2"])
