#!/usr/bin/env python3
"""Why a B=1 train-step gradient on the GPU can differ from the CPU's.

Runs the port's T2S training forward and backward (``T2SConfig()``, fp32,
seeded random weights, the two-row batch of ``chip_smoke.py``'s card-vs-CPU
check) on cuda and on the CPU, for row 1 alone and for both rows, and
prints for each layer how many ReLU inputs of the FFN took another sign on
the two devices (with the largest such |input|), the relative L2 of the
gradient at each layer's input, and the same gradients when the card runs
with the CPU's ReLU pattern imposed. A single input within ~1e-6 of zero
that flips moves its whole contribution to the gradient: the error jumps
at that layer and carries down. Run on a machine with a GPU:

    python3 scripts/torch_train_relu_flips.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from genie_tts_tpu_torch.config import T2SConfig  # noqa: E402
from genie_tts_tpu_torch.convert.io import flatten_tree, unflatten_tree  # noqa: E402
from genie_tts_tpu_torch.models import t2s  # noqa: E402
from genie_tts_tpu_torch.models.t2s import (_merge_heads, _prefill_mask,  # noqa: E402
                                            _split_heads, embed_text)
from genie_tts_tpu_torch.ops.layers import (attention, layer_norm, linear,  # noqa: E402
                                            sine_position_table, unstack)
from genie_tts_tpu_torch.parallel.train import make_batch  # noqa: E402


def run(params0, cfg, batch, dev, rows, patterns=None):
    """Forward and backward of ``t2s.train_loss``'s math, layer by layer:
    (the FFN ReLU pattern of each layer, its inputs, the gradient at each
    layer's input). ``patterns``: ReLU patterns to impose."""
    leaves = {k: v.detach().to(dev).requires_grad_(True)
              for k, v in flatten_tree(params0).items()}
    params = unflatten_tree(leaves)
    b = {k: torch.as_tensor(v[rows], device=dev) for k, v in batch.items()}
    x = embed_text(params, b["phones"], b["bert"])
    _, Sx, D = x.shape
    Sy = b["semantic"].shape[1]
    pe = sine_position_table(Sy, D, device=x.device)
    h = torch.cat([x, params["audio_embed"][b["semantic"]]
                   + (params["audio_pos_alpha"] * pe)[None]], 1)
    mask = _prefill_mask(Sx, Sy, b["x_len"], b["sem_len"])[:, None]
    pats, pres, ins = [], [], []
    layers = {k: v for k, v in params["layers"].items() if not k.startswith("_")}
    for i, lp in enumerate(unstack(layers)):
        h.retain_grad()
        ins.append(h)
        q, k, v = linear(lp["qkv"], h).chunk(3, -1)
        q, k, v = (_split_heads(t, cfg.num_heads) for t in (q, k, v))
        h1 = layer_norm(lp["norm1"], h + linear(lp["out"],
                                                 _merge_heads(attention(q, k, v, mask))))
        pre = linear(lp["ffn1"], h1)
        pat = (pre > 0) if patterns is None else patterns[i].to(dev)
        pats.append(pat.cpu())
        pres.append(pre.detach().cpu())
        h = layer_norm(lp["norm2"], h1 + linear(lp["ffn2"], pre * pat))
    logits = h[:, Sx:].float() @ params["predict"]["w"].float()
    total, _ = t2s.masked_nll(logits, b["semantic"], b["sem_len"], cfg.eos_id)
    total.backward()
    return pats, pres, [t.grad.detach().cpu() for t in ins]


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = T2SConfig()
    params = t2s.init_params(torch.Generator(device="cuda").manual_seed(8), cfg,
                             dtype=torch.float32)
    batch = make_batch(cfg, 2, sx=64, sy=128, seed=1)
    batch["x_len"][1] = 41
    batch["sem_len"][1] = 90
    print(torch.cuda.get_device_name(0))
    for name, rows in (("row 1 alone (B=1)", slice(1, 2)), ("both rows (B=2)", slice(0, 2))):
        pc, _, gc = run(params, cfg, batch, "cuda", rows)
        ph, preh, gh = run(params, cfg, batch, "cpu", rows)
        flips = {i: (int((a != b).sum()), float(preh[i][a != b].abs().max()))
                 for i, (a, b) in enumerate(zip(pc, ph)) if bool((a != b).any())}
        _, _, gi = run(params, cfg, batch, "cuda", rows, patterns=ph)
        print(f"{name}: ReLU inputs of another sign, by layer: "
              + (", ".join(f"layer {i}: {n} (|input| <= {m:.1e})" for i, (n, m) in flips.items())
                 or "none"))
        print("  gradient at each layer's input, card vs CPU, relative L2 (layer 0 first): "
              + " ".join(f"{rel(a, b):.1e}" for a, b in zip(gc, gh)))
        print("  the same with the CPU's ReLU pattern on the card: "
              + " ".join(f"{rel(a, b):.1e}" for a, b in zip(gi, gh)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
