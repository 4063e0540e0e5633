"""Whether what the timed path served is correct: a comparison with the
plain reference (``perfbench/reference/``), run once the window has
closed, the peak memory read and the program's state freed.

The reference makes the weights again from the seed (the same bits),
reads the reference clip's WAV as the program did (16-bit PCM, 0.3 s of
silence appended, polyphase resampling to 16 kHz), and works out again
everything the program derived: the transcript's and each text's
phonemes (its frozen frontend), RoBERTa's features for Chinese text,
HuBERT's features, the prompt tokens, and through the configuration's
family (``families/<family>.py``, its ``Check``) what only that family
derives, such as the speaker conditioning. Then, for a sample of
finished greedy requests drawn from the seed with the longest among
them, one teacher-forced pass of the decoder over the prompt and the
served tokens gives the logits behind each served token; the number
compared is the widest gap by which a served token's logit lies below
the best one under the greedy rule. The family compares what else the
entry kept of each request (``Check.request``: its whole record), such
as the audio of rows served without flow noise.

Numbers, each with its limit from the cell's file:

- ``logit_gap``: that widest gap, over every served token of the sample;
- ``phones_differ``: requests of the sample whose phonemes, as the
  program's frontend gave them, differ from the reference's;
- ``ssl_err``: the relative L2 distance between HuBERT's features of the
  reference clip, as the program's reference path made them, and the
  reference's (the prompt tokens are the nearest codebook rows to them:
  their own distance, ``prompt_gap``, is logged beside, since the
  nearest row is the same at any precision but for a rare near tie);
- ``length_differ``: finished requests whose audio is not codes x the
  family's ``samples_per_code`` samples long;
- ``bert_err`` (Chinese): the widest relative L2 distance, over the
  sample, between the BERT rows the program's frontend gave a text and
  the reference RoBERTa's;
- the family's own (its module's docstring).

With ``control``, the reference is also run in the program's place one
step below the precision the configuration states (int4 weight-only
decoder matmuls with bfloat16 activations; RoBERTa int8 weight-only;
HuBERT and the family's models in bfloat16), and its readings of the
same numbers are returned under ``"control"``: the token the control's
decoder puts first at each step of the same served tokens, its
features, and the family's readings. The control's frontend and lengths
are the reference's own, so it reads 0 on the exact numbers.
:func:`judge` holds it to the cell's limits as it holds the program."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import spec, weights
from .traffic import Request

SILENCE_S = 0.3


def clip_16k(clip: np.ndarray, sr: int) -> np.ndarray:
    from scipy.signal import resample_poly

    audio = clip.astype(np.float32) / 32768.0
    audio = np.concatenate([audio, np.zeros(int(SILENCE_S * sr), np.float32)])
    return resample_poly(audio, 1, sr // 16000).astype(np.float32)


class Reference:
    """The reference's own view of one configuration and seed; with
    ``control``, the control's features beside it."""

    def __init__(self, cfg: Dict, seed: int, device, clip: np.ndarray, tokenizer=None,
                 control: bool = False):
        from ..reference import hubert as ref_hubert, t2s as ref_t2s
        from ..reference.frontend import phones as ref_phones
        from .system import clip_rate

        self.cfg, self.device = cfg, torch.device(device)
        self.t2s = weights.make("t2s", cfg, seed, self.device)
        self.roberta = (weights.make("roberta", cfg, seed, self.device)
                        if cfg.get("roberta") else None)
        self.tokenizer = tokenizer
        hub = weights.make("hubert", cfg, seed, self.device)
        audio = torch.as_tensor(clip_16k(clip, clip_rate(cfg)), device=self.device)
        heads = int(cfg["hubert"].get("num_heads", 12))
        self.ssl = ref_hubert.features(hub, audio, heads)
        self.distances = ref_t2s.prompt_distances(self.t2s, self.ssl)
        self.prompts = self.distances.argmin(-1)
        self.control_ssl = (ref_hubert.features(hub, audio, heads, act=torch.bfloat16)
                            if control else None)
        del hub
        self.family = spec.family(cfg["family"]).Check(cfg, seed, self.device, clip, audio,
                                                       control)
        self._phones = ref_phones
        self.ref_phones, self.ref_bert = self.text(cfg["reference_clip"]["text"])

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


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative L2 distance of ``a`` from ``b`` (inf where shapes differ)."""
    if a.shape != b.shape:
        return float("inf")
    return float((a.float() - b.float()).norm() / b.float().norm())


def compare(cfg: Dict, seed: int, device, clip: np.ndarray, program: Dict,
            sample: List[Request], finished: List[Request],
            control: bool = False) -> Dict[str, float]:
    """The numbers compared (see the module's docstring). ``program``: what
    the program's set-up derived from the clip (``System.derived``)."""
    from ..reference import fp32, t2s as ref_t2s
    from ..reference.frontend.wordpiece import WordPieceTokenizer
    from .system import scratch_dir

    tok = None
    if cfg.get("roberta"):
        tok = WordPieceTokenizer.from_file(scratch_dir() / f"tokenizer-{cfg['name']}.json")
    per_code = spec.family(cfg["family"]).samples_per_code(cfg)
    out = {"length_differ": float(sum(
        r.rec.get("samples") != r.codes * per_code for r in finished))}
    ctl = {"length_differ": 0.0, "phones_differ": 0.0}
    with fp32(), torch.inference_mode():
        ref = Reference(cfg, seed, device, clip, tok, control=control)

        def prog(name):
            return torch.as_tensor(np.asarray(program[name], np.float32), device=ref.device)

        out["ssl_err"] = rel(prog("ssl"), ref.ssl)
        own, own_ctl = ref.family.setup_numbers(program)
        out.update(own)
        if control:
            ctl["ssl_err"] = rel(ref.control_ssl, ref.ssl)
            ctl.update(own_ctl)
        pp = torch.as_tensor(np.asarray(program["prompts"]), device=ref.device)
        out["prompt_gap"] = ref_t2s.prompt_gap(ref.distances, pp)
        out["prompts_not_nearest"] = float((pp[:len(ref.prompts)] != ref.prompts[:len(pp)]).sum())
        eos = int(cfg["t2s"].get("eos_id", 1024))
        gap, cgap, differ, tokens_seen, flips = 0.0, 0.0, 0, 0, 0
        berr, cberr = [], []
        for r in sample:
            ph, bert = ref.text(r.text)
            if bert is not None:
                prog_bert = torch.as_tensor(
                    r.rec.get("bert", np.zeros(tuple(bert.shape), np.float32)),
                    device=ref.device)
                berr.append(rel(prog_bert, bert))
                if control:
                    cberr.append(rel(ref.text(r.text, control=True)[1], bert))
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
            ref.family.request(r.rec, tokens, ph)
        out["phones_differ"] = float(differ)
        if berr:
            out["bert_err"] = max(berr)
            if control:
                ctl["bert_err"] = max(cberr)
        own, own_ctl = ref.family.request_numbers()
        out.update(own)
        ctl.update(own_ctl)
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
