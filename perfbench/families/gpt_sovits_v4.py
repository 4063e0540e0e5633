"""The family ``gpt_sovits_v4``: GPT-SoVITS V4 (``SynthesizerTrnV3``,
``version="v4"``).

V2's decoder, HuBERT, RoBERTa and V2's text side of the synthesizer
(its style encoder over the first 704 bins of the clip's spectrogram
gives ``ge``), then ``decode_encp`` (bridge, 2x nearest, WaveNet), the
DiT under conditional flow matching over a 100-band mel, chunked and
prompted with the clip's own mel, and a 48 kHz HiFi-GAN: four mel
frames of 480 samples a code. The configuration's ``v4`` section holds
the mel side's widths (the port's ``V4Config``). What this module
provides is what ``families/gpt_sovits_v2.py``'s docstring lists; the
text side's init rules and the tiny synthesizer are that family's.

The numbers only this family compares, each with its limit from the
cell's file:

- ``ge_err``: the relative L2 distance of the program's ``ge`` from the
  reference's;
- ``mel_err`` (greedy rows served with a ``cfm_seed``, whose CFM mel the
  entry kept): the widest relative L2 distance, over the sample, of the
  program's sampled mel (normalised, all chunks) from the reference's,
  given the same served tokens and seed;
- ``audio_err``: the same for the 48 kHz waveform, with
  ``audio_compared``, the rows compared, beside it.

The reference (``reference/sovits_v4.py``) derives its own prompt: the
clip's mel (without the silence the program appends for HuBERT and the
spectrogram), the prompt tokens from its own HuBERT and decoder, and
their ``decode_encp`` with the transcript's phonemes.

The control (``Check(..., control=True)``): the DiT's linears with their
weights and inputs rounded to float8 e4m3 (per-tensor scale), one step
below the bfloat16 DiT, and the rest of the synthesizer in bfloat16."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.harness import spec, weights
from perfbench.harness.check import SILENCE_S, rel
from perfbench.harness.system import clip_rate

v2 = spec.family("gpt_sovits_v2")

# the mel side of the CPU tests: the published structure at a few units of
# width, a few Euler steps, short chunks (several a request) and a small vocoder
TINY_V4 = {"fea_channels": 16, "wn_layers": 2, "dit_dim": 32, "dit_depth": 2,
           "dit_heads": 2, "dit_head_dim": 16, "freq_embed_dim": 16, "sample_steps": 4,
           "T_ref": 16, "T_chunk": 40, "upsample_rates": [2, 2, 2],
           "upsample_kernels": [4, 4, 4], "upsample_initial": 32, "resblock_kernels": [3],
           "resblock_dilations": [[1, 3]]}

# (std of a weight as a multiple of fan-in scaling, std of its bias) of the
# leaves upstream zero-initialises or leaves at their default, drawn so that
# every block acts: the adaLN modulations (shift, scale, gate) come out
# around 0.3, GRN's gamma and beta at 0.1, the output projection at plain
# fan-in scaling; every other bias of the mel side at 0.02
DRAWN = {"blocks/ada": (1.0, 0.1), "norm_out": (1.0, 0.1), "proj_out": (1.0, 0.02)}
GRN_STD = 0.1
BIAS_STD = 0.02

TEXT_SIDE = ("quantizer_embed", "enc_p", "ref_enc")


def v4_config(cfg: Dict):
    """The port's ``V4Config`` of the configuration's ``v4`` section."""
    from genie_tts_tpu_torch.config import V4Config

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    return V4Config(**{k: tup(v) for k, v in cfg["v4"].items()})


def models(cfg: Dict) -> List[str]:
    out = ["t2s", "sovits", "hubert"]
    if cfg.get("roberta"):
        out.append("roberta")
    return out


def port_init(model: str, cfg: Dict):
    if model != "sovits":
        return v2.port_init(model, cfg)
    from genie_tts_tpu_torch.models import sovits_v4

    dt = getattr(torch, cfg.get("dtype", "bfloat16"))
    scfg, v4 = v2.sovits_config(cfg), v4_config(cfg)
    return lambda g: sovits_v4.init_params(g, scfg, v4, dtype=dt)


def init_rule(model: str, path: Tuple[str, ...], shape) -> Tuple[float, float]:
    """V2's rules for every model but the synthesizer's mel side; there,
    fan-in scaling (a dense ``w`` is [in, out] behind any stacked block
    axis, a conv's [width, in/groups, out] behind one), :data:`DRAWN`'s
    gains, LayerNorm at one and zero, GRN and biases drawn."""
    if model != "sovits" or path[0] in TEXT_SIDE:
        return v2.init_rule(model, path, shape)
    joined = "/".join(path)
    name = path[-1]
    key = next((k for k in DRAWN if joined.startswith("cfm/" + k + "/")), None)
    if path[:2] == ("cfm", "text_blocks") and path[2] == "norm":
        return (1.0, 0.0) if name == "scale" else (0.0, 0.0)
    if path[:2] == ("cfm", "text_blocks") and path[2] == "grn":
        return 0.0, GRN_STD
    if name == "b":
        return 0.0, DRAWN[key][1] if key else BIAS_STD
    if name == "w":
        stacked = path[:2] in (("cfm", "blocks"), ("cfm", "text_blocks"))
        dims = shape[1:] if stacked else shape
        fan = dims[-2] if len(dims) == 2 else dims[-3] * dims[-2]
        return 0.0, (DRAWN[key][0] if key else 1.0) * fan ** -0.5
    raise ValueError(f"no init rule for {model}:{joined} {tuple(shape)}")


def character(cfg: Dict, trees: Dict) -> Dict:
    return dict(version="v4", sovits_params=trees["sovits"], sovits_cfg=v2.sovits_config(cfg),
                v4_cfg=v4_config(cfg))


def sv_fn(trees: Dict, device, kept: Dict):
    return None


def derived(features, kept: Dict) -> Dict[str, np.ndarray]:
    """``ge`` and the CFM's prompt (``mel2``, ``fea_ref``) as the port's
    reference path gave them."""
    return {"ge": np.asarray(features.ge, np.float32),
            "mel2": features.mel2.float().cpu().numpy(),
            "fea_ref": features.fea_ref.float().cpu().numpy()}


def output_rate(cfg: Dict) -> int:
    return v4_config(cfg).sample_rate


def samples_per_code(cfg: Dict) -> int:
    return v4_config(cfg).samples_per_code


def tiny(cfg: Dict) -> None:
    """V2's tiny synthesizer (its text side) and :data:`TINY_V4`."""
    cfg["sovits"] = dict(v2.TINY_SOVITS, version="v4")
    cfg["v4"] = dict(cfg["v4"], **TINY_V4)


class Check:
    """The family's part of the check, on the reference's device in
    float32: the synthesizer's weights made again from the seed, the
    reference's own ``ge`` and CFM prompt (and with ``control`` the
    control's beside them), the numbers of the module's docstring."""

    def __init__(self, cfg: Dict, seed: int, device, clip: np.ndarray,
                 audio_16k: torch.Tensor, control: bool = False):
        from perfbench.reference import hubert as ref_hubert, t2s as ref_t2s
        from perfbench.reference.frontend import phones as ref_phones

        self.cfg, self.device, self.control = cfg, device, control
        self.v4 = dict(vars(v4_config(cfg)))
        self.heads = int(cfg["sovits"]["n_heads"])
        self.sovits = weights.make("sovits", cfg, seed, device)
        hub = weights.make("hubert", cfg, seed, device)
        ssl = ref_hubert.features(hub, audio_16k, int(cfg["hubert"].get("num_heads", 12)))
        del hub
        t2s = weights.make("t2s", cfg, seed, device)
        self.prompts = ref_t2s.prompt_tokens(t2s, ssl)
        del t2s
        text = cfg["reference_clip"]["text"]
        ids = ref_phones.chinese(text)[0] if cfg["language"] == "zh" else \
            ref_phones.japanese(text)
        self.ref_phones = torch.as_tensor(ids, dtype=torch.long, device=device)
        self.clip = clip
        self.prompt = self.conditioning()
        self.control_prompt = self.conditioning(torch.bfloat16) if control else None
        self.merr, self.aerr, self.cmerr, self.caerr = [], [], [], []

    def conditioning(self, act=torch.float32):
        """(ge [gin], fea_ref [P, C], mel2 [P, M]): the style vector of the
        spectrogram of the clip with the appended silence (its first 704
        bins), the mel of the clip alone, and the prompt codes'
        ``decode_encp``, cut to their common length."""
        from perfbench.reference import sovits as ref_sovits, sovits_v4 as ref

        s = self.cfg["sovits"]
        clip = self.clip.astype(np.float32) / 32768.0
        a32 = np.concatenate([clip, np.zeros(int(SILENCE_S * clip_rate(self.cfg)), np.float32)])
        spec_ = ref_sovits.spectrogram(torch.as_tensor(a32, device=self.device), s["n_fft"],
                                       s["hop_length"], s["win_length"])
        bins = self.sovits["ref_enc"]["spectral0"]["w"].shape[0]
        ge = ref_sovits.style(self.sovits["ref_enc"], spec_[:bins], act)
        mel2 = ref.mel(torch.as_tensor(clip, device=self.device), self.v4)
        fea = ref.decode_encp(self.sovits, self.prompts, self.ref_phones, ge, self.heads, act)
        mel2, fea_ref = ref.prompt_cut(mel2, fea, self.v4["T_ref"])
        return ge, fea_ref, mel2

    def setup_numbers(self, program: Dict) -> Tuple[Dict[str, float], Dict[str, float]]:
        ge = torch.as_tensor(np.asarray(program["ge"], np.float32), device=self.device)
        out = {"ge_err": rel(ge.reshape(-1), self.prompt[0])}
        ctl = {"ge_err": rel(self.control_prompt[0], self.prompt[0])} if self.control else {}
        return out, ctl

    def synthesize(self, tokens, phones, seed: int, control: bool = False):
        """(the sampled mel, the waveform) of the served tokens (the last
        vocoded as code 0) under the reference's (or the control's)
        prompt, with the request's CFM seed."""
        from perfbench.reference import sovits_v4 as ref

        act = torch.bfloat16 if control else torch.float32
        ge, fea_ref, mel2 = self.control_prompt if control else self.prompt
        codes = torch.cat([tokens[:-1], torch.zeros_like(tokens[-1:])])
        fea = ref.decode_encp(self.sovits, codes, phones, ge, self.heads, act)
        return ref.synthesize(self.sovits, self.v4, fea, fea_ref, mel2, seed, act, fp8=control)

    def request(self, rec: Dict, tokens: torch.Tensor, phones: torch.Tensor) -> None:
        """A greedy row whose audio, mel and CFM seed the entry kept has
        both compared."""
        if rec.get("pcm") is None or rec.get("mel") is None or rec.get("cfm_seed") is None:
            return
        want_mel, want = self.synthesize(tokens, phones, rec["cfm_seed"])
        got = torch.as_tensor(rec["pcm"].astype(np.float32) / 32767.0, device=self.device)
        self.aerr.append(rel(got, want))
        self.merr.append(rel(torch.as_tensor(np.asarray(rec["mel"], np.float32),
                                             device=self.device), want_mel))
        if self.control:
            cmel, caudio = self.synthesize(tokens, phones, rec["cfm_seed"], control=True)
            self.cmerr.append(rel(cmel, want_mel))
            self.caerr.append(rel(caudio, want))

    def request_numbers(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        out, ctl = {}, {}
        if self.aerr:
            out.update(mel_err=max(self.merr), audio_err=max(self.aerr),
                       audio_compared=float(len(self.aerr)))
            if self.control:
                ctl.update(mel_err=max(self.cmerr), audio_err=max(self.caerr))
        return out, ctl
