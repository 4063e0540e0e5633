"""The family ``gpt_sovits_v2``: GPT-SoVITS V2 and V2ProPlus.

A configuration names its family (``"family"`` in ``configs/<name>.json``)
and the harness finds the module ``families/<family>.py`` by that name
(``harness/spec.py::family``). What differs between GPT-SoVITS versions
lives here; what they share (the decoder, HuBERT, RoBERTa, the frontend,
the prompt tokens, the teacher-forced logits) stays in ``harness/``. A
family provides:

- ``models(cfg)``, ``port_init(model, cfg)``, ``init_rule(model, path,
  shape)``: the trees a configuration runs, in a fixed order; the port's
  init function of each (its layout, in the served dtype); the (mean,
  std) of each leaf (``harness/weights.py``);
- ``character(cfg, trees)``, ``sv_fn(trees, device, kept)``,
  ``derived(features, kept)``: the family's arguments of the port's
  ``CharacterModel``; the speaker-verification function the port's
  reference path calls, or None; what set-up derived from the clip
  besides the prompt tokens and HuBERT's features (``harness/system.py``);
- ``Check``: the family's part of the correctness check, built by the
  reference with its own view of the clip (``harness/check.py``);
- ``output_rate(cfg)``, ``samples_per_code(cfg)``: the served audio's
  sample rate, and the samples one semantic code becomes;
- ``tiny(cfg)``: the family's part of the CPU tests' tiny configuration.

V2 conditions the synthesizer on its style encoder's embedding of the
clip's spectrogram. V2ProPlus has no style encoder: the ERes2NetV2
embedding of the clip and a prompt encoder (gin 1024) give the
conditioning. Both vocode with HiFi-GAN at 32 kHz, two latent frames of
``hop_length`` samples a code.

The numbers only this family compares, each with its limit from the
cell's file:

- ``ge_err``: the relative L2 distance of the program's speaker
  conditioning from the reference's (V2ProPlus: the larger of ``ge``'s
  and ``ge_mrte``'s);
- ``sv_err`` (V2ProPlus): the same for the SV embedding of the clip;
- ``audio_err`` (rows served without flow noise): the widest relative
  L2 distance, over the sample, of the program's waveform from the
  reference's (the latent at the prior's mean and HiFi-GAN), with
  ``audio_compared``, the rows compared, beside it.

The control (``Check(..., control=True)``) runs the speaker encoders,
the SV model and the synthesizer in bfloat16."""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.harness import weights
from perfbench.harness.check import SILENCE_S, rel
from perfbench.harness.system import clip_rate

# Gains on fan-in scaling. At plain fan-in scaling the 24 post-LN decoder
# layers collapse every position onto one vector (near-uniform attention
# over a few hundred keys adds the same average to every row, layer after
# layer): the logits no longer depend on the position or the text. Sharper
# attention (q, k and v at twice the scale) with a small output
# projection, and embeddings at unit scale, keep the rows apart.
GAINS = {("t2s", "layers/qkv/w"): 2.0, ("t2s", "layers/out/w"): 0.1}

# the synthesizer of the CPU tests: the published structure at a few units of width
TINY_SOVITS = {"spec_channels": 33, "inter_channels": 16, "hidden_channels": 16,
               "filter_channels": 32, "n_heads": 2, "n_layers": 2, "kernel_size": 3,
               "mrte_channels": 16, "ssl_dim": 24, "vq_codes": 1024, "vq_dim": 24,
               "gin_channels": 16, "flow_layers": 2, "wn_layers": 2, "wn_kernel": 5,
               "upsample_rates": [2, 2, 2], "upsample_kernels": [4, 4, 4],
               "upsample_initial": 32, "resblock_kernels": [3], "resblock_dilations": [[1, 3]],
               "n_fft": 64, "hop_length": 8, "win_length": 64, "sv_dim": 20480}


def sovits_config(cfg: Dict):
    from genie_tts_tpu_torch.config import SoVITSConfig

    kw = {k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
          if isinstance(v, list) else v for k, v in cfg["sovits"].items()}
    return SoVITSConfig(**kw)


def models(cfg: Dict) -> List[str]:
    """The models a configuration runs, in a fixed order."""
    out = ["t2s", "sovits", "hubert"]
    if cfg.get("version") == "v2ProPlus":
        out += ["prompt_encoder", "sv"]
    if cfg.get("roberta"):
        out.append("roberta")
    return out


def port_init(model: str, cfg: Dict):
    """The init function (taking a generator) of a model of the port, in
    the configuration's dtype."""
    from genie_tts_tpu_torch import config as pc
    from genie_tts_tpu_torch.models import (eres2net, hubert, prompt_encoder, roberta,
                                            sovits, t2s)

    dt = getattr(torch, cfg.get("dtype", "bfloat16"))
    if model == "t2s":
        return lambda g: t2s.init_params(g, pc.T2SConfig(**cfg["t2s"]), dtype=dt)
    if model == "sovits":
        vcfg = sovits_config(cfg)

        def init(g):
            p = sovits.init_params(g, vcfg, dtype=dt)
            if vcfg.version == "v2ProPlus":      # a converted V2ProPlus has no style encoder
                del p["ref_enc"]
            return p
        return init
    if model == "prompt_encoder":
        vcfg = sovits_config(cfg)
        return lambda g: prompt_encoder.init_params(g, vcfg, dtype=dt, gin=vcfg.gin_channels,
                                                    mrte_dim=vcfg.mrte_channels)
    if model == "hubert":
        return lambda g: hubert.init_params(g, pc.HubertConfig(**cfg["hubert"]), dtype=dt)
    if model == "roberta":
        return lambda g: roberta.init_params(g, pc.RobertaConfig(**cfg["roberta"]), dtype=dt)
    if model == "sv":
        return lambda g: eres2net.init_params(g, dtype=dt)
    raise ValueError(f"unknown model {model!r}")


def init_rule(model: str, path: Tuple[str, ...], shape) -> Tuple[float, float]:
    """(mean, std) of a leaf: fan-in scaling for weights (a dense ``w`` is
    [in, out] behind any stacked layer axis, a conv's [width, in, out],
    a 2-D conv's [h, w, in, out]) times :data:`GAINS`, embeddings at 0.02
    (the decoder's at 1), norms at one and zero; in the decoder (``t2s``)
    biases and norms drawn around those values, so each layer's differ."""
    name = path[-1]
    joined = "/".join(path)
    stacked = model in ("t2s", "hubert", "roberta") and path[0] == "layers"
    if name in ("text_pos_alpha", "audio_pos_alpha"):
        return 1.0, 0.0
    if name == "prelu_weight":
        return 0.25, 0.0
    if name in ("scale", "gamma"):
        return 1.0, (0.1 if model == "t2s" else 0.0)
    if name in ("bias", "beta", "b"):
        return 0.0, (0.1 if model == "t2s" else 0.0)
    if name in ("codebook", "quantizer_embed"):
        return 0.0, 1.0
    if model == "t2s" and joined in ("text_embed", "audio_embed"):
        return 0.0, 1.0
    if re.search(r"(text_embed|audio_embed|word_embed|pos_embed|type_embed)$", joined):
        return 0.0, 0.02
    if name.startswith("emb_rel"):
        return 0.0, shape[-1] ** -0.5
    if model == "t2s" and joined == "ssl_proj/w":
        return 0.0, 0.03
    if model == "hubert" and joined == "pos_conv/w":
        return 0.0, 0.02
    if name == "w":
        if stacked or len(shape) == 2:
            fan = shape[-2]
        elif model == "sv":
            fan = shape[0] * shape[1] * shape[2]
        else:
            fan = shape[-3] * shape[-2]
        return 0.0, GAINS.get((model, joined), 0.3 if (model == "sv" and "conv3" in path)
                              else 1.0) * fan ** -0.5
    raise ValueError(f"no init rule for {model}:{joined} {tuple(shape)}")


def character(cfg: Dict, trees: Dict) -> Dict:
    """The family's arguments of the port's ``CharacterModel``."""
    vcfg = sovits_config(cfg)
    return dict(version=vcfg.version, sovits_params=trees["sovits"], sovits_cfg=vcfg,
                prompt_encoder_params=trees.get("prompt_encoder"))


def sv_fn(trees: Dict, device, kept: Dict):
    """V2ProPlus: the port's SV function (``models/sv.py::make_sv_fn``),
    keeping the embedding it gives under ``kept["sv"]``; V2: None."""
    if "sv" not in trees:
        return None
    from genie_tts_tpu_torch.models import sv

    port_sv = sv.make_sv_fn(trees["sv"], device)

    def fn(audio_16k):
        kept["sv"] = np.asarray(port_sv(audio_16k), np.float32)
        return kept["sv"]
    return fn


def derived(features, kept: Dict) -> Dict[str, np.ndarray]:
    """The speaker conditioning the port's reference path gave
    (``ReferenceFeatures``), and (V2ProPlus) the SV embedding."""
    return {"ge": np.asarray(features.ge, np.float32),
            "ge_mrte": np.asarray(features.ge_mrte, np.float32), **kept}


def output_rate(cfg: Dict) -> int:
    return sovits_config(cfg).sample_rate


def samples_per_code(cfg: Dict) -> int:
    """Two latent frames of ``hop_length`` samples."""
    return 2 * sovits_config(cfg).hop_length


def tiny(cfg: Dict) -> None:
    """Cut ``cfg``'s synthesizer to :data:`TINY_SOVITS` (V2ProPlus: gin 32)."""
    sov = dict(TINY_SOVITS, version=cfg["sovits"]["version"])
    if sov["version"] == "v2ProPlus":
        sov["gin_channels"] = 32
    cfg["sovits"] = sov


class Check:
    """The family's part of the check (``harness/check.py``), on the
    reference's device in float32: the synthesizer's weights made again
    from the seed, the speaker conditioning worked out again from the
    clip (and with ``control`` the control's beside it), and the numbers
    of the module's docstring."""

    def __init__(self, cfg: Dict, seed: int, device, clip: np.ndarray,
                 audio_16k: torch.Tensor, control: bool = False):
        self.cfg, self.device, self.control = cfg, device, control
        self.sovits = weights.make("sovits", cfg, seed, device)
        self.ge, self.ge_mrte, self.sv = self.conditioning(clip, audio_16k, seed)
        self.control_cond = (self.conditioning(clip, audio_16k, seed, act=torch.bfloat16)
                             if control else None)
        self.aerr, self.caerr = [], []

    def conditioning(self, clip: np.ndarray, audio_16k: torch.Tensor, seed: int,
                     act=torch.float32):
        """(ge, ge_mrte, SV embedding or None) of the clip: the spectrogram
        of the 32 kHz clip with the silence the program appends, through
        V2's style encoder, or V2ProPlus's SV model and prompt encoder."""
        from perfbench.reference import sovits as ref_sovits, sv as ref_sv

        s = self.cfg["sovits"]
        a32 = np.concatenate([clip.astype(np.float32) / 32768.0,
                              np.zeros(int(SILENCE_S * clip_rate(self.cfg)), np.float32)])
        spec = ref_sovits.spectrogram(torch.as_tensor(a32, device=self.device), s["n_fft"],
                                      s["hop_length"], s["win_length"])
        if self.cfg.get("version") == "v2ProPlus":
            sv_p = weights.make("sv", self.cfg, seed, self.device)
            emb = ref_sv.embedding(sv_p, audio_16k, act)
            del sv_p
            pe = weights.make("prompt_encoder", self.cfg, seed, self.device)
            ge, ge_mrte = ref_sovits.prompt_encoder(pe, spec, emb, act)
            return ge, ge_mrte, emb
        ge = ref_sovits.style(self.sovits["ref_enc"], spec, act)
        return ge, ge[: s["mrte_channels"]], None

    def setup_numbers(self, program: Dict) -> Tuple[Dict[str, float], Dict[str, float]]:
        """(``ge_err`` and ``sv_err`` of what the program's set-up derived
        (:func:`derived`), the control's readings or nothing)."""
        def prog(name):
            return torch.as_tensor(np.asarray(program[name], np.float32), device=self.device)

        out = {"ge_err": max(rel(prog("ge").reshape(-1), self.ge),
                             rel(prog("ge_mrte").reshape(-1), self.ge_mrte))}
        if self.sv is not None:
            out["sv_err"] = rel(prog("sv"), self.sv)
        ctl = {}
        if self.control:
            cge, cmrte, csv = self.control_cond
            ctl["ge_err"] = max(rel(cge, self.ge), rel(cmrte, self.ge_mrte))
            if csv is not None:
                ctl["sv_err"] = rel(csv, self.sv)
        return out, ctl

    def audio(self, tokens, phones, control: bool = False) -> torch.Tensor:
        """The waveform of the served tokens: the latent at the prior's
        mean and HiFi-GAN, under the reference's (or the control's)
        conditioning. The last served token is vocoded as code 0, as
        GPT-SoVITS's inference does with the token that ends a decode."""
        from perfbench.reference import sovits as ref_sovits

        s = self.cfg["sovits"]
        act = torch.bfloat16 if control else torch.float32
        ge, ge_mrte, _ = self.control_cond if control else (self.ge, self.ge_mrte, None)
        codes = torch.cat([tokens[:-1], torch.zeros_like(tokens[-1:])])
        z = ref_sovits.latent(self.sovits, codes, phones, ge, ge_mrte, int(s["n_heads"]), act)
        return ref_sovits.vocode(self.sovits, z, ge, s["upsample_rates"], s["upsample_kernels"],
                                 s["resblock_kernels"], s["resblock_dilations"], act)

    def request(self, rec: Dict, tokens: torch.Tensor, phones: torch.Tensor) -> None:
        """One request of the sample: its whole record as the entry kept
        it, its served tokens and the reference's phonemes of its text.
        A row served without flow noise (``rec["pcm"]``) has its audio
        compared."""
        if rec.get("pcm") is None:
            return
        want = self.audio(tokens, phones)
        got = torch.as_tensor(rec["pcm"].astype(np.float32) / 32767.0, device=self.device)
        self.aerr.append(rel(got, want))
        if self.control:
            self.caerr.append(rel(self.audio(tokens, phones, control=True), want))

    def request_numbers(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        """(``audio_err`` and ``audio_compared`` over the sample, the
        control's ``audio_err``), empty where no row had its audio kept."""
        out, ctl = {}, {}
        if self.aerr:
            out["audio_err"] = max(self.aerr)
            out["audio_compared"] = float(len(self.aerr))
            if self.control:
                ctl["audio_err"] = max(self.caerr)
        return out, ctl
