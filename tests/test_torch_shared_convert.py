"""The port's shared-model converters, conversion API and CLI, and the
model manager's test hooks, against the JAX package.

* ``convert_hubert`` / ``convert_roberta`` on synthetic HF-layout state
  dicts (numpy from a seed; HuBERT's positional conv in both weight-norm
  key layouts) equal the JAX converters' trees leaf for leaf, exactly.
* The port's HuBERT and RoBERTa forwards on the converted trees match the
  JAX forwards in fp32: rtol 1e-4, atol 1e-5 (as
  ``tests/test_torch_roberta.py``), and transformers' ``HubertModel`` /
  ``BertModel`` loaded with the same state dicts: rtol 1e-4, atol 1e-4.
* ``convert_shared_models`` under a temporary ``GENIE_DATA_DIR`` writes
  the files the JAX function writes for the same call, and the port's
  ``load_hubert`` / ``load_roberta`` serve them.
* ``api.convert_model`` and ``convert_to_onnx`` write what
  ``convert_character`` writes; the CLI's ``convert --version v2ProPlus``
  writes what ``convert_character(version="v2ProPlus")`` writes.
* ``ModelManager.register`` and ``set_hubert``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.config import HubertConfig as JHubertConfig
from genie_tts_tpu.config import RobertaConfig as JRobertaConfig
from genie_tts_tpu.convert import shared_models as jshared
from genie_tts_tpu.models import hubert as jhubert
from genie_tts_tpu.models import roberta as jroberta
from genie_tts_tpu_torch import api
from genie_tts_tpu_torch.config import (HubertConfig, RobertaConfig, RuntimeConfig,
                                        SoVITSConfig, T2SConfig)
from genie_tts_tpu_torch.convert import shared_models as tshared
from genie_tts_tpu_torch.convert import torch_convert as tconv
from genie_tts_tpu_torch.convert.io import (flatten_tree, load_params,
                                            params_from_numpy, read_safetensors)
from genie_tts_tpu_torch.frontend import dispatcher as tdispatch
from genie_tts_tpu_torch.frontend.wordpiece import bert_layout
from genie_tts_tpu_torch.models import hubert, roberta
from genie_tts_tpu_torch.runtime.engine import make_random_character
from genie_tts_tpu_torch.runtime.model_manager import ModelManager
from test_torch_convert import T2S_KW, ckpts  # noqa: F401  (the checkpoint fixture)
import test_convert as jtests

HUB_KW = dict(conv_dims=(8,) * 7, embed_dim=32, num_layers=2, num_heads=2,
              ffn_dim=64, conv_pos_kernel=16, conv_pos_groups=2)
ROB_KW = dict(vocab_size=100, embed_dim=32, num_layers=3, num_heads=2, ffn_dim=64,
              max_position=64)


# convert_shared_models converts at the default layer counts
HUB_FULL_DEPTH = dict(HUB_KW, num_layers=HubertConfig().num_layers)
ROB_FULL_DEPTH = dict(ROB_KW, num_layers=RobertaConfig().num_layers)


def hubert_sd(legacy=True, seed=0, kw=HUB_KW):
    """The smoke run's HF-layout HuBERT state dict at test widths."""
    from chip_smoke import hf_hubert_state_dict

    return hf_hubert_state_dict(HubertConfig(**kw), seed, legacy=legacy)


def roberta_sd(seed=0, kw=ROB_KW):
    """A random BERT checkpoint in the layout of chinese-roberta-wwm-ext-
    large's ``pytorch_model.bin`` (``bert.`` prefix, an MLM head key the
    converter skips), numpy fp32."""
    rng = np.random.default_rng(seed)
    D, F = kw["embed_dim"], kw["ffn_dim"]
    sd = {}

    def randn(*shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def ln(key):
        sd[f"{key}.weight"] = 1.0 + randn(D, std=0.1)
        sd[f"{key}.bias"] = randn(D, std=0.1)

    def lin(key, i, o):
        sd[f"{key}.weight"] = randn(o, i, std=i ** -0.5)
        sd[f"{key}.bias"] = randn(o, std=0.02)

    sd["embeddings.word_embeddings.weight"] = randn(ROB_KW["vocab_size"], D, std=0.5)
    sd["embeddings.position_embeddings.weight"] = randn(ROB_KW["max_position"], D, std=0.5)
    sd["embeddings.token_type_embeddings.weight"] = randn(2, D, std=0.5)
    ln("embeddings.LayerNorm")
    for i in range(kw["num_layers"]):
        p = f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            lin(f"{p}.attention.self.{name}", D, D)
        lin(f"{p}.attention.output.dense", D, D)
        ln(f"{p}.attention.output.LayerNorm")
        lin(f"{p}.intermediate.dense", D, F)
        lin(f"{p}.output.dense", F, D)
        ln(f"{p}.output.LayerNorm")
    sd = {f"bert.{k}": v for k, v in sd.items()}
    sd["cls.predictions.bias"] = randn(ROB_KW["vocab_size"])
    return sd


def assert_same_tree(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], k)


def audio(seed=0, n=3200):
    return np.random.default_rng(seed).standard_normal((1, n)).astype(np.float32) * 0.3


@pytest.mark.parametrize("legacy", [True, False])
def test_hubert_converter_and_forward_match_jax(legacy):
    sd = hubert_sd(legacy)
    assert ("encoder.pos_conv_embed.conv.weight_g" in sd) == legacy
    tree = tshared.convert_hubert(sd, HubertConfig(**HUB_KW))
    assert_same_tree(tree, jshared.convert_hubert(sd, JHubertConfig(**HUB_KW)))
    # both key layouts of the same weights give the same tree
    assert_same_tree(tree, tshared.convert_hubert(hubert_sd(not legacy),
                                                  HubertConfig(**HUB_KW)))
    x = audio()
    ref = np.asarray(jhubert.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                                   JHubertConfig(**HUB_KW)))
    out = hubert.apply(params_from_numpy(tree, torch.float32), torch.as_tensor(x),
                       HubertConfig(**HUB_KW))
    assert out.shape == ref.shape == (1, 9, 32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_roberta_converter_and_forward_match_jax():
    sd = roberta_sd()
    tree = tshared.convert_roberta(sd, RobertaConfig(**ROB_KW))
    assert_same_tree(tree, jshared.convert_roberta(sd, JRobertaConfig(**ROB_KW)))
    ids = np.random.default_rng(1).integers(0, ROB_KW["vocab_size"], (1, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 10:] = 0
    ref = np.asarray(jroberta.hidden_states(jax.tree.map(jnp.asarray, tree),
                                            jnp.asarray(ids), jnp.asarray(mask),
                                            JRobertaConfig(**ROB_KW)))
    out = roberta.hidden_states(params_from_numpy(tree, torch.float32),
                                torch.as_tensor(ids), torch.as_tensor(mask),
                                RobertaConfig(**ROB_KW))
    assert out.shape == ref.shape == (4, 1, 12, 32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_hubert_matches_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.HubertConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, conv_dim=(8,) * 7,
        conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2),
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2,
        do_stable_layer_norm=False, feat_extract_norm="group",
        hidden_dropout=0.0, attention_dropout=0.0, layerdrop=0.0,
        feat_proj_dropout=0.0, activation_dropout=0.0)
    model = transformers.HubertModel(hf_cfg).eval()
    legacy = "encoder.pos_conv_embed.conv.weight_g" in model.state_dict()
    sd = hubert_sd(legacy)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    x = audio(2)
    with torch.no_grad():
        ref = model(torch.as_tensor(x)).last_hidden_state.numpy()
    out = hubert.apply(params_from_numpy(tshared.convert_hubert(sd, HubertConfig(**HUB_KW)),
                                         torch.float32),
                       torch.as_tensor(x), HubertConfig(**HUB_KW))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_roberta_matches_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BertConfig(
        vocab_size=ROB_KW["vocab_size"], hidden_size=32, num_hidden_layers=3,
        num_attention_heads=2, intermediate_size=64, max_position_embeddings=64,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = transformers.BertModel(hf_cfg, add_pooling_layer=False).eval()
    sd = roberta_sd(3)
    model.load_state_dict({k.removeprefix("bert."): torch.from_numpy(v)
                           for k, v in sd.items() if k.startswith("bert.")}, strict=False)
    missing = set(model.state_dict()) - {k.removeprefix("bert.") for k in sd}
    assert missing <= {"embeddings.position_ids", "embeddings.token_type_ids"}, missing
    ids = torch.randint(0, ROB_KW["vocab_size"], (1, 10), generator=torch.Generator().manual_seed(0))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        ref = model(ids, attention_mask=mask, output_hidden_states=True).hidden_states
    out = roberta.hidden_states(params_from_numpy(tshared.convert_roberta(
        sd, RobertaConfig(**ROB_KW)), torch.float32), ids, mask, RobertaConfig(**ROB_KW))
    assert out.shape[0] == len(ref)
    for i in range(len(ref)):
        np.testing.assert_allclose(out[i].numpy(), ref[i].numpy(), rtol=1e-4, atol=1e-4)


def _hf_dirs(root):
    hub, rob = root / "hf-hubert", root / "hf-roberta"
    hub.mkdir()
    rob.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in hubert_sd(kw=HUB_FULL_DEPTH).items()},
               hub / "pytorch_model.bin")
    torch.save({k: torch.from_numpy(v) for k, v in roberta_sd(kw=ROB_FULL_DEPTH).items()},
               rob / "pytorch_model.bin")
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4, "你": 5, "好": 6}
    (rob / "tokenizer.json").write_text(json.dumps(bert_layout(vocab)), encoding="utf-8")
    return hub, rob


def test_convert_shared_models_writes_what_load_hubert_and_roberta_serve(
        tmp_path, monkeypatch):
    monkeypatch.delenv("GENIE_HUBERT_DIR", raising=False)
    monkeypatch.delenv("GENIE_ROBERTA_DIR", raising=False)
    hub_in, rob_in = _hf_dirs(tmp_path)
    written = {}
    for name, fn in (("jax", jshared.convert_shared_models),
                     ("torch", tshared.convert_shared_models)):
        monkeypatch.setenv("GENIE_DATA_DIR", str(tmp_path / name))
        # out_root is computed and never used (the JAX function's fault,
        # mirrored): the files go to GENIE_DATA_DIR
        fn(hubert_dir_in=hub_in, roberta_dir_in=rob_in, out_root=tmp_path / f"{name}-out")
        assert not (tmp_path / f"{name}-out").exists()
        written[name] = {rel: read_safetensors(tmp_path / name / rel) for rel in
                         ("chinese-hubert-base/hubert.safetensors",
                          "RoBERTa/roberta.safetensors")}
    for rel, tensors in written["jax"].items():
        assert_same_tree(written["torch"][rel], tensors)
    assert (tmp_path / "torch/RoBERTa/tokenizer.json").read_bytes() == \
        (rob_in / "tokenizer.json").read_bytes()

    # the port's model manager serves what was written (GENIE_DATA_DIR = torch)
    (tmp_path / "torch/chinese-hubert-base/config.json").write_text(json.dumps(HUB_FULL_DEPTH))
    (tmp_path / "torch/RoBERTa/config.json").write_text(json.dumps(ROB_FULL_DEPTH))
    mm = ModelManager(RuntimeConfig(compute_dtype="float32"))
    params, hcfg = mm.load_hubert("cpu")
    assert hcfg == HubertConfig(**HUB_FULL_DEPTH)
    on_disk = load_params(tmp_path / "torch/chinese-hubert-base/hubert.safetensors",
                          torch.float32)
    assert_same_tree({k: v.numpy() for k, v in flatten_tree(params).items()},
                     {k: v.numpy() for k, v in flatten_tree(on_disk).items()})
    assert hubert.apply(params, torch.as_tensor(audio()), hcfg).shape == (1, 9, 32)
    try:
        rparams, rcfg, tok = mm.load_roberta("cpu")
        assert rcfg == RobertaConfig(**ROB_FULL_DEPTH)
        assert tok.encode("你好").ids == [2, 5, 6, 3]
        assert rparams["word_embed"].shape == (ROB_KW["vocab_size"], 32)
    finally:
        tdispatch.set_bert_feature_fn(None)


def test_api_convert_model_and_alias_equal_convert_character(ckpts, tmp_path, monkeypatch):
    vcfg = jtests.TestSoVITSConversion.CFG
    monkeypatch.setattr(tconv, "T2SConfig", lambda: T2SConfig(**T2S_KW))
    monkeypatch.setattr(tconv, "SoVITSConfig", lambda: SoVITSConfig(
        **{k: getattr(vcfg, k) for k in vcfg.__dataclass_fields__}))
    ck, pth = ckpts / "model_e8.ckpt", ckpts / "model_e8.pth"
    tconv.convert_character(ck, pth, tmp_path / "ref", language="Japanese")
    assert api.convert_model(ck, pth, tmp_path / "api") is None
    api.convert_to_onnx(str(ck), str(pth), str(tmp_path / "alias"))
    import genie_tts_tpu_torch as genie

    assert genie.convert_model is api.convert_model
    for out in ("api", "alias"):
        _assert_same_character(tmp_path / out, tmp_path / "ref")


def _assert_same_character(a, b):
    for name in ("t2s.safetensors", "vits.safetensors"):
        assert_same_tree(read_safetensors(a / name), read_safetensors(b / name))
    assert json.loads((a / "config.json").read_text()) == \
        json.loads((b / "config.json").read_text())


def test_cli_convert_version_flag(ckpts, tmp_path, monkeypatch, capsys):
    from genie_tts_tpu_torch import __main__ as cli

    vcfg = jtests.TestSoVITSConversion.CFG
    monkeypatch.setattr(tconv, "T2SConfig", lambda: T2SConfig(**T2S_KW))
    monkeypatch.setattr(tconv, "SoVITSConfig", lambda: SoVITSConfig(
        **{k: getattr(vcfg, k) for k in vcfg.__dataclass_fields__}))
    ck, pth = ckpts / "model_e8.ckpt", ckpts / "model_e8.pth"
    args = ["convert", "--ckpt", str(ck), "--pth", str(pth)]
    assert cli.main(args + ["--out", str(tmp_path / "pp"), "--version", "v2ProPlus"]) == 0
    assert "converted v2ProPlus" in capsys.readouterr().out
    tconv.convert_character(ck, pth, tmp_path / "ref", language="ja", version="v2ProPlus")
    _assert_same_character(tmp_path / "pp", tmp_path / "ref")
    assert json.loads((tmp_path / "pp/config.json").read_text())["version"] == "v2ProPlus"
    assert cli.main(args + ["--out", str(tmp_path / "auto")]) == 0
    assert json.loads((tmp_path / "auto/config.json").read_text())["version"] == "v2"
    with pytest.raises(SystemExit):
        cli.main(args + ["--out", str(tmp_path / "bad"), "--version", "v3"])


def test_register_and_set_hubert(monkeypatch, tmp_path):
    monkeypatch.setenv("GENIE_HUBERT_DIR", str(tmp_path / "nowhere"))
    mm = ModelManager()
    char = make_random_character(
        "registered", t2s_cfg=T2SConfig(**dict(T2S_KW, semantic_vocab=1025, eos_id=1024)),
        sovits_cfg=SoVITSConfig(inter_channels=16, hidden_channels=16, filter_channels=32,
                                n_layers=2, mrte_channels=16, ssl_dim=24, vq_dim=24,
                                gin_channels=16, flow_layers=2, wn_layers=2,
                                upsample_initial=32, resblock_kernels=(3,),
                                resblock_dilations=((1, 3),)),
        device="cpu")
    mm.register(char)
    assert mm.get("registered") is char
    assert mm.load_hubert("cpu") is None            # no checkpoint on disk
    cfg = HubertConfig(**HUB_KW)
    p1 = params_from_numpy(tshared.convert_hubert(hubert_sd(seed=1), cfg), torch.float32)
    p2 = params_from_numpy(tshared.convert_hubert(hubert_sd(seed=2), cfg), torch.float32)
    mm.set_hubert(p1, cfg)
    assert mm.load_hubert("cpu")[0] is p1 and mm.load_hubert("cpu")[1] == cfg
    # the api's HuBERT forward follows set_hubert
    monkeypatch.setattr(api, "model_manager", mm)
    monkeypatch.setattr(api, "_hubert_fns", {})
    x = audio(4)[0]
    f1 = api._hubert_fn("cpu")
    assert api._hubert_fn("cpu") is f1
    mm.set_hubert(p2, cfg)
    f2 = api._hubert_fn("cpu")
    assert f2 is not f1
    np.testing.assert_allclose(f2(x), hubert.apply(p2, torch.as_tensor(x)[None], cfg)[0].numpy(),
                               rtol=1e-6, atol=1e-6)
    assert not np.allclose(f1(x), f2(x))
