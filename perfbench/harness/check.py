"""Whether what the timed path served is correct: a comparison with the
plain reference (``perfbench/reference/``), run once the window has
closed, the peak memory read and the program's state freed.

The reference makes the weights again from the seed (the same bits),
reads the reference clip's WAV as the program did (16-bit PCM, 0.3 s of
silence appended, polyphase resampling to 16 kHz), and works out again
everything the program derived: the transcript's and each text's
phonemes (its frozen frontend), RoBERTa's features for Chinese text,
HuBERT's features, the prompt tokens, the speaker conditioning (V2: the
style encoder over the clip's spectrogram; V2ProPlus: the ERes2NetV2
embedding of the clip and the prompt encoder). Then, for a sample of
finished greedy requests drawn from the seed with the longest among
them, one teacher-forced pass of the decoder over the prompt and the
served tokens gives the logits behind each served token; the number
compared is the widest gap by which a served token's logit lies below
the best one under the greedy rule. Where the entry served the sample's
audio without flow noise (the solo cell's greedy rows), the reference
synthesizes the served tokens (the latent at the prior's mean, HiFi-GAN)
and compares the waveforms.

Numbers, each with its limit from the cell's file:

- ``logit_gap``: that widest gap, over every served token of the sample;
- ``phones_differ``: requests of the sample whose phonemes, as the
  program's frontend gave them, differ from the reference's;
- ``ssl_err``: the relative L2 distance between HuBERT's features of the
  reference clip, as the program's reference path made them, and the
  reference's (the prompt tokens are the nearest codebook rows to them:
  their own distance, ``prompt_gap``, is logged beside, since the
  nearest row is the same at any precision but for a rare near tie);
- ``ge_err``: the relative L2 distance of the program's speaker
  conditioning from the reference's (V2ProPlus: the larger of ``ge``'s
  and ``ge_mrte``'s);
- ``sv_err`` (V2ProPlus): the same for the SV embedding of the clip;
- ``audio_err`` (noise-free rows): the widest relative L2 distance, over
  the sample, of the program's waveform from the reference's;
- ``length_differ``: finished requests whose audio is not 2 x codes x hop
  samples long;
- ``bert_err`` (Chinese): the widest relative L2 distance, over the
  sample, between the BERT rows the program's frontend gave a text and
  the reference RoBERTa's.

With ``control``, the reference is also run in the program's place one
step below the precision the configuration states (int4 weight-only
decoder matmuls with bfloat16 activations; RoBERTa int8 weight-only;
HuBERT, the SV model, the speaker encoders and the synthesizer in
bfloat16), and its readings of the same numbers are returned under
``"control"``: the token the control's decoder puts first at each step
of the same served tokens, its features, its conditioning and its audio.
The control's frontend and lengths are the reference's own, so it reads
0 on the exact numbers. :func:`judge` holds it to the cell's limits as
it holds the program."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import weights
from .traffic import Request

SILENCE_S = 0.3


def clip_16k(clip: np.ndarray, sr: int) -> np.ndarray:
    from scipy.signal import resample_poly

    audio = clip.astype(np.float32) / 32768.0
    audio = np.concatenate([audio, np.zeros(int(SILENCE_S * sr), np.float32)])
    return resample_poly(audio, 1, sr // 16000).astype(np.float32)


class Reference:
    """The reference's own view of one configuration and seed; with
    ``control``, the control's conditioning beside it."""

    def __init__(self, cfg: Dict, seed: int, device, clip: np.ndarray, tokenizer=None,
                 control: bool = False):
        from ..reference import hubert as ref_hubert, t2s as ref_t2s
        from ..reference.frontend import phones as ref_phones

        self.cfg, self.device = cfg, torch.device(device)
        self.t2s = weights.make("t2s", cfg, seed, self.device)
        self.sovits = weights.make("sovits", cfg, seed, self.device)
        self.roberta = (weights.make("roberta", cfg, seed, self.device)
                        if cfg.get("roberta") else None)
        self.tokenizer = tokenizer
        hub = weights.make("hubert", cfg, seed, self.device)
        sr = int(cfg["sovits"].get("sample_rate", 32000))
        audio = torch.as_tensor(clip_16k(clip, sr), device=self.device)
        heads = int(cfg["hubert"].get("num_heads", 12))
        self.ssl = ref_hubert.features(hub, audio, heads)
        self.distances = ref_t2s.prompt_distances(self.t2s, self.ssl)
        self.prompts = self.distances.argmin(-1)
        self.control_ssl = (ref_hubert.features(hub, audio, heads, act=torch.bfloat16)
                            if control else None)
        del hub
        self.ge, self.ge_mrte, self.sv = self.conditioning(clip, audio, seed)
        self.control_cond = (self.conditioning(clip, audio, seed, act=torch.bfloat16)
                             if control else None)
        self._phones = ref_phones
        self.ref_phones, self.ref_bert = self.text(cfg["reference_clip"]["text"])

    def conditioning(self, clip: np.ndarray, audio_16k: torch.Tensor, seed: int,
                     act=torch.float32):
        """(ge, ge_mrte, SV embedding or None) of the clip: the spectrogram
        of the 32 kHz clip with the silence the program appends, through
        V2's style encoder, or V2ProPlus's SV model and prompt encoder."""
        from ..reference import sovits as ref_sovits, sv as ref_sv

        s = self.cfg["sovits"]
        a32 = np.concatenate([clip.astype(np.float32) / 32768.0,
                              np.zeros(int(SILENCE_S * s.get("sample_rate", 32000)), np.float32)])
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

    def text(self, text: str, control: bool = False):
        """(phonemes [T] int64 tensor, BERT features [T, D] or None); with
        ``control`` RoBERTa runs in the control's precision (int8
        weight-only matmuls, bfloat16 activations)."""
        from ..reference import quant, roberta as ref_roberta

        if self.cfg["language"] == "zh":
            ids, norm, word2ph = self._phones.chinese(text)
            bert = None
            if self.roberta is not None:
                enc = self.tokenizer.encode(norm)
                if len(enc.ids) - 2 == len(word2ph):
                    kw = (dict(weight=lambda w: quant.fake_quant(w, 8), act=torch.bfloat16)
                          if control else {})
                    bert = ref_roberta.phone_features(
                        self.roberta, enc.ids, word2ph,
                        int(self.cfg["roberta"].get("num_heads", 16)),
                        int(self.cfg["roberta"].get("feature_layer", -3)), **kw)
        else:
            ids, bert = self._phones.japanese(text), None
        return torch.as_tensor(ids, dtype=torch.long, device=self.device), bert

    def logits(self, phones, bert, tokens, control: bool = False):
        from ..reference import quant, t2s as ref_t2s

        heads = int(self.cfg["t2s"].get("num_heads", 16))
        if control:
            return ref_t2s.logits(self.t2s, phones, bert, self.prompts, tokens, heads,
                                  weight=quant.fake_quant, act=torch.bfloat16)
        return ref_t2s.logits(self.t2s, phones, bert, self.prompts, tokens, heads)

    def audio(self, tokens, phones, control: bool = False) -> torch.Tensor:
        """The waveform of the served tokens: the latent at the prior's
        mean and HiFi-GAN, under the reference's (or the control's)
        conditioning. The last served token is vocoded as code 0, as
        GPT-SoVITS's inference does with the token that ends a decode."""
        from ..reference import sovits as ref_sovits

        s = self.cfg["sovits"]
        act = torch.bfloat16 if control else torch.float32
        ge, ge_mrte, _ = self.control_cond if control else (self.ge, self.ge_mrte, None)
        codes = torch.cat([tokens[:-1], torch.zeros_like(tokens[-1:])])
        z = ref_sovits.latent(self.sovits, codes, phones, ge, ge_mrte, int(s["n_heads"]), act)
        return ref_sovits.vocode(self.sovits, z, ge, s["upsample_rates"], s["upsample_kernels"],
                                 s["resblock_kernels"], s["resblock_dilations"], act)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative L2 distance of ``a`` from ``b`` (inf where shapes differ)."""
    if a.shape != b.shape:
        return float("inf")
    return float((a.float() - b.float()).norm() / b.float().norm())


def compare(cfg: Dict, seed: int, device, clip: np.ndarray, program: Dict,
            sample: List[Request], finished: List[Request], hop: int,
            control: bool = False) -> Dict[str, float]:
    """The numbers compared (see the module's docstring). ``program``: what
    the program's set-up derived from the clip (``prompts``, ``ssl``,
    ``ge``, ``ge_mrte``, and ``sv`` in V2ProPlus)."""
    from ..reference import fp32, t2s as ref_t2s
    from ..reference.frontend.wordpiece import WordPieceTokenizer
    from .system import scratch_dir

    tok = None
    if cfg.get("roberta"):
        tok = WordPieceTokenizer.from_file(scratch_dir() / f"tokenizer-{cfg['name']}.json")
    out = {"length_differ": float(sum(
        r.rec.get("samples") != 2 * r.codes * hop for r in finished))}
    ctl = {"length_differ": 0.0, "phones_differ": 0.0}
    with fp32(), torch.inference_mode():
        ref = Reference(cfg, seed, device, clip, tok, control=control)

        def prog(name):
            return torch.as_tensor(np.asarray(program[name], np.float32), device=ref.device)

        out["ssl_err"] = _rel(prog("ssl"), ref.ssl)
        out["ge_err"] = max(_rel(prog("ge").reshape(-1), ref.ge),
                            _rel(prog("ge_mrte").reshape(-1), ref.ge_mrte))
        if ref.sv is not None:
            out["sv_err"] = _rel(prog("sv"), ref.sv)
        if control:
            cge, cmrte, csv = ref.control_cond
            ctl["ssl_err"] = _rel(ref.control_ssl, ref.ssl)
            ctl["ge_err"] = max(_rel(cge, ref.ge), _rel(cmrte, ref.ge_mrte))
            if csv is not None:
                ctl["sv_err"] = _rel(csv, ref.sv)
        pp = torch.as_tensor(np.asarray(program["prompts"]), device=ref.device)
        out["prompt_gap"] = ref_t2s.prompt_gap(ref.distances, pp)
        out["prompts_not_nearest"] = float((pp[:len(ref.prompts)] != ref.prompts[:len(pp)]).sum())
        eos = int(cfg["t2s"].get("eos_id", 1024))
        gap, cgap, differ, tokens_seen, flips = 0.0, 0.0, 0, 0, 0
        berr, cberr, aerr, caerr = [], [], [], []
        for r in sample:
            ph, bert = ref.text(r.text)
            if bert is not None:
                prog_bert = torch.as_tensor(
                    r.rec.get("bert", np.zeros(tuple(bert.shape), np.float32)),
                    device=ref.device)
                berr.append(_rel(prog_bert, bert))
                if control:
                    cberr.append(_rel(ref.text(r.text, control=True)[1], bert))
            differ += int(not np.array_equal(np.asarray(r.rec["phones"]), ph.cpu().numpy()))
            phones = torch.cat([ref.ref_phones, ph])
            if ref.ref_bert is None and bert is None:
                b = None
            else:
                dim = ref.t2s["bert_proj"]["w"].shape[0]
                zeros = torch.zeros
                b = torch.cat([ref.ref_bert if ref.ref_bert is not None
                               else zeros((len(ref.ref_phones), dim), device=ref.device),
                               bert if bert is not None
                               else zeros((len(ph), dim), device=ref.device)])
            tokens = torch.as_tensor(r.rec["tokens"], device=ref.device)
            z = ref.logits(phones, b, tokens)
            g = ref_t2s.greedy_gaps(z, tokens, ref.prompts, r.rec["penalty"], eos,
                                    r.rec["min_steps"])
            gap = max(gap, float(g.max()))
            flips += int((g > 0).sum())
            tokens_seen += len(tokens)
            if control:
                zc = ref.logits(phones, b, tokens, control=True)
                gc = ref_t2s.greedy_gaps(z, tokens, ref.prompts, r.rec["penalty"], eos,
                                         r.rec["min_steps"], choose=zc)
                cgap = max(cgap, float(gc.max()))
            if r.rec.get("pcm") is not None:
                want = ref.audio(tokens, ph)
                got = torch.as_tensor(r.rec["pcm"].astype(np.float32) / 32767.0,
                                      device=ref.device)
                aerr.append(_rel(got, want))
                if control:
                    caerr.append(_rel(ref.audio(tokens, ph, control=True), want))
        out["phones_differ"] = float(differ)
        if berr:
            out["bert_err"] = max(berr)
            if control:
                ctl["bert_err"] = max(cberr)
        if aerr:
            out["audio_err"] = max(aerr)
            out["audio_compared"] = float(len(aerr))
            if control:
                ctl["audio_err"] = max(caerr)
        out["logit_gap"] = gap
        out["tokens_compared"] = float(tokens_seen)
        out["tokens_not_best"] = float(flips)
        if control:
            ctl["logit_gap"] = cgap
            out["control"] = ctl
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) over the numbers that have a limit."""
    rows = [(k, numbers[k], float(limits[k])) for k in limits if k in numbers]
    missing = [k for k in limits if k not in numbers]
    ok = not missing and all(v <= lim for _, v, lim in rows)
    return ok, rows
