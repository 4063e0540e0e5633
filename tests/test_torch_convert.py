"""The port's checkpoint converter vs the JAX package's.

The same small torch ``.ckpt``/``.pth`` files (the SoVITS state dict of
tests/test_convert.py, a 2-layer T2S) go through both packages'
``convert_character``; the files they write must hold the same tensors,
bit for bit, and the same config.json, and the port's model manager loads
the result. V2ProPlus forced on a checkpoint without prompt-encoder
tensors writes what the JAX package writes (no prompt encoder), and the
port's model manager refuses the directory. The ``convert`` CLI writes
the same files.
"""
import json

import numpy as np
import pytest
import torch

import test_convert as jtests
from genie_tts_tpu.config import T2SConfig as JT2SConfig
from genie_tts_tpu.convert import torch_convert as jconv
from genie_tts_tpu_torch.config import SoVITSConfig, T2SConfig
from genie_tts_tpu_torch.convert import torch_convert as tconv
from genie_tts_tpu_torch.convert.io import read_safetensors
from genie_tts_tpu_torch.runtime.model_manager import ModelManager

T2S_KW = dict(phoneme_vocab=732, semantic_vocab=33, embed_dim=32, num_layers=2,
              num_heads=4, ffn_dim=64, bert_dim=1024, ssl_dim=24, eos_id=32,
              max_decode_steps=8)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    g = torch.Generator().manual_seed(1)
    ckpt_sd = {}

    def t2(key, *shape):
        ckpt_sd[f"model.{key}"] = torch.randn(*shape, generator=g) * 0.1

    t2("ar_text_embedding.word_embeddings.weight", 732, 32)
    t2("ar_audio_embedding.word_embeddings.weight", 33, 32)
    t2("ar_text_position.alpha", 1)
    t2("ar_audio_position.alpha", 1)
    t2("bert_proj.weight", 32, 1024)
    t2("bert_proj.bias", 32)
    t2("ar_predict_layer.weight", 33, 32)
    for i in range(2):
        p = f"h.layers.{i}"
        for name, shape in (("self_attn.in_proj_weight", (96, 32)),
                            ("self_attn.in_proj_bias", (96,)),
                            ("self_attn.out_proj.weight", (32, 32)),
                            ("self_attn.out_proj.bias", (32,)),
                            ("linear1.weight", (64, 32)), ("linear1.bias", (64,)),
                            ("linear2.weight", (32, 64)), ("linear2.bias", (32,)),
                            ("norm1.weight", (32,)), ("norm1.bias", (32,)),
                            ("norm2.weight", (32,)), ("norm2.bias", (32,))):
            t2(f"{p}.{name}", *shape)
    torch.save({"weight": ckpt_sd}, root / "model_e8.ckpt")
    pth_sd = {k: torch.from_numpy(np.asarray(v))
              for k, v in jtests.TestSoVITSConversion()._torch_sd().items()}
    pth_sd["ssl_proj.weight"] = torch.randn(24, 24, 2, generator=g) * 0.1
    pth_sd["ssl_proj.bias"] = torch.randn(24, generator=g) * 0.1
    torch.save({"weight": pth_sd}, root / "model_e8.pth")
    return root


def _files(d):
    return {name: read_safetensors(d / name) for name in ("t2s.safetensors",
                                                          "vits.safetensors")}


def _same_files(a, b):
    fa, fb = _files(a), _files(b)
    for name in fa:
        assert set(fa[name]) == set(fb[name]), name
        for k, v in fa[name].items():
            assert v.dtype == fb[name][k].dtype, k
            np.testing.assert_array_equal(v, fb[name][k], k)
    assert json.loads((a / "config.json").read_text()) == \
        json.loads((b / "config.json").read_text())


def test_convert_writes_the_jax_tensors(ckpts, tmp_path):
    vcfg = jtests.TestSoVITSConversion.CFG
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    assert jconv.convert_character(ckpts / "model_e8.ckpt", ckpts / "model_e8.pth", jout,
                                   language="ja", version="v2",
                                   t2s_cfg=JT2SConfig(**T2S_KW), sovits_cfg=vcfg) == "v2"
    tcfg = SoVITSConfig(**{k: getattr(vcfg, k) for k in vcfg.__dataclass_fields__})
    assert tconv.convert_character(ckpts / "model_e8.ckpt", ckpts / "model_e8.pth", tout,
                                   language="ja", version="v2",
                                   t2s_cfg=T2SConfig(**T2S_KW), sovits_cfg=tcfg) == "v2"
    _same_files(jout, tout)
    char = ModelManager().load_character("conv", str(tout), "ja", device="cpu")
    assert char.t2s_cfg.num_layers == 2 and char.sovits_cfg.upsample_rates == (2, 2)


def test_flow_stack_matches_tree_map(ckpts):
    """The port stacks the flow layers without jax.tree.map."""
    sd = {k: v.numpy() for k, v in torch.load(ckpts / "model_e8.pth",
                                               weights_only=True)["weight"].items()}
    vcfg = jtests.TestSoVITSConversion.CFG
    j = jconv.convert_sovits(sd, vcfg)["flow"]
    t = tconv.convert_sovits(sd, vcfg)["flow"]
    from genie_tts_tpu.convert.io import flatten_tree

    fj, ft = flatten_tree(j), flatten_tree(t)
    assert set(fj) == set(ft)
    for k in fj:
        np.testing.assert_array_equal(fj[k], ft[k], k)


def test_v2proplus_is_refused(ckpts, tmp_path):
    vcfg = jtests.TestSoVITSConversion.CFG
    jout, tout = tmp_path / "jax", tmp_path / "pp"
    jconv.convert_character(ckpts / "model_e8.ckpt", ckpts / "model_e8.pth", jout,
                            language="ja", version="v2ProPlus",
                            t2s_cfg=JT2SConfig(**T2S_KW), sovits_cfg=vcfg)
    tcfg = SoVITSConfig(**{k: getattr(vcfg, k) for k in vcfg.__dataclass_fields__})
    assert tconv.convert_character(ckpts / "model_e8.ckpt", ckpts / "model_e8.pth", tout,
                                   language="ja", version="v2ProPlus",
                                   t2s_cfg=T2SConfig(**T2S_KW),
                                   sovits_cfg=tcfg) == "v2ProPlus"
    _same_files(jout, tout)
    assert not (tout / "prompt_encoder.safetensors").exists()
    with pytest.raises(FileNotFoundError, match="prompt_encoder"):
        ModelManager().load_character("pp", str(tout), "ja", device="cpu")


def test_cli_convert(ckpts, tmp_path, monkeypatch):
    """The CLI converts at the default model sizes; here the defaults are
    the small checkpoints' sizes."""
    from genie_tts_tpu_torch import __main__ as cli

    vcfg = jtests.TestSoVITSConversion.CFG
    monkeypatch.setattr(tconv, "T2SConfig", lambda: T2SConfig(**T2S_KW))
    monkeypatch.setattr(tconv, "SoVITSConfig", lambda: SoVITSConfig(
        **{k: getattr(vcfg, k) for k in vcfg.__dataclass_fields__}))
    out = tmp_path / "cli"
    assert cli.main(["convert", "--ckpt", str(ckpts / "model_e8.ckpt"), "--pth",
                     str(ckpts / "model_e8.pth"), "--out", str(out)]) == 0
    ref = tmp_path / "ref"
    jconv.convert_character(ckpts / "model_e8.ckpt", ckpts / "model_e8.pth", ref,
                            language="ja", version="v2", t2s_cfg=JT2SConfig(**T2S_KW),
                            sovits_cfg=vcfg)
    fa, fb = _files(out), _files(ref)
    for name in fa:
        assert set(fa[name]) == set(fb[name])
        for k, v in fa[name].items():
            np.testing.assert_array_equal(v, fb[name][k], k)
