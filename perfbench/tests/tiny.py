"""Tiny configurations and cells for the harness's CPU tests: the
published structure at a few units of width, small bucket ladders and a
short ring, so a whole run (set-up, window, check) fits a test."""
from __future__ import annotations

import copy

from perfbench.harness import spec

T2S = {"phoneme_vocab": 732, "semantic_vocab": 1025, "embed_dim": 32, "num_layers": 2,
       "num_heads": 4, "ffn_dim": 64, "bert_dim": 16, "ssl_dim": 24, "eos_id": 1024,
       "max_decode_steps": 64}
HUBERT = {"conv_dims": [16] * 7, "embed_dim": 24, "num_layers": 1, "num_heads": 4,
          "ffn_dim": 32, "conv_pos_kernel": 16, "conv_pos_groups": 4}
ROBERTA = {"vocab_size": 21128, "embed_dim": 16, "num_layers": 4, "num_heads": 2,
           "ffn_dim": 32, "max_position": 512, "feature_layer": -3}
RUNTIME = {"frame_buckets": [16, 32, 64], "step_caps": [16, 32, 64], "slot_batch": 4,
           "slot_steps": 8, "slot_join_steps": 4, "slot_ring": 32, "vocode_chunk": 16,
           "vocode_halo": 12}
# the halo holds the tiny generator's receptive field (~9 latent frames; the
# family cuts the synthesizer), as the published halo of 24 holds the
# published one (~14)


def config(name: str) -> dict:
    """A configuration of ``configs/`` cut to the tiny widths above."""
    cfg = copy.deepcopy(spec.config(name))
    cfg["t2s"] = dict(T2S)
    spec.family(cfg["family"]).tiny(cfg)
    cfg["hubert"] = dict(HUBERT)
    if cfg.get("roberta"):
        cfg["roberta"] = dict(ROBERTA)
    cfg["runtime"] = dict(RUNTIME)
    cfg["dtype"] = "float32"
    cfg["reference_clip"] = dict(cfg["reference_clip"], seconds=1.0)
    cfg["length_rule"] = {"codes_per_phoneme": 0.3, "min_codes": 8, "max_codes": 24}
    return cfg


def cell(name: str, **mix) -> spec.Cell:
    """The cell ``name`` on its tiny configuration, its mix's parameters
    overridden by ``mix``."""
    c = spec.cell(name)
    c.config = config(spec.load_json(spec.ROOT / "workloads" / f"{name}.json")["config"])
    c.traffic = dict(c.traffic, warm_seconds=0.5, **mix)
    return c
