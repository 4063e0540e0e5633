"""One tiny character loaded by both packages, for the port's parity tests
(tests/test_torch_batcher.py, test_torch_stream.py,
test_torch_session_server.py import its helpers).

The character is made by the port's ``init_params`` and written by its
``save_params`` (narrow widths, the real 640-sample hop, ``config.json``
overrides, embeddings x10 and the EOS column x3 so greedy decodes vary and
end inside the cap), and read by each package's model manager in fp32
without int8 decode weights.
Both packages' ReferenceFeatures come from the same reference arrays.
Its own test: the files the port writes load as the same tensors in both
packages (exactly: fp16 on disk, widened the same way).
"""
import json
import wave

import jax.numpy as jnp
import numpy as np
import torch

from genie_tts_tpu.config import RuntimeConfig as JRuntimeConfig
from genie_tts_tpu.runtime import engine as jengine
from genie_tts_tpu.runtime.model_manager import ModelManager as JModelManager
from genie_tts_tpu_torch.config import HubertConfig, RuntimeConfig, SoVITSConfig, T2SConfig
from genie_tts_tpu_torch.convert.io import save_params
from genie_tts_tpu_torch.models import hubert, sovits, t2s
from genie_tts_tpu_torch.runtime import engine as tengine
from genie_tts_tpu_torch.runtime.model_manager import ModelManager

T2S_KW = dict(embed_dim=32, num_layers=2, num_heads=4, ffn_dim=64, bert_dim=1024,
              ssl_dim=24, max_decode_steps=24)
VITS_KW = dict(inter_channels=16, hidden_channels=16, filter_channels=32,
               n_layers=2, mrte_channels=16, ssl_dim=24, vq_dim=24,
               gin_channels=16, flow_layers=2, wn_layers=2, upsample_initial=32,
               resblock_kernels=(3,), resblock_dilations=((1, 3),))
HUBERT_KW = dict(conv_dims=(32,) * 7, embed_dim=24, num_layers=2, num_heads=4,
                 ffn_dim=48, conv_pos_kernel=16, conv_pos_groups=4)
HOP = 640


def write_character(root):
    """A tiny V2 character dir, a tiny HuBERT dir and a 3.2 s reference
    wav under ``root``; returns their paths."""
    char = root / "char"
    char.mkdir()
    gen = torch.Generator().manual_seed(0)
    tp = t2s.init_params(gen, T2SConfig(**T2S_KW), dtype=torch.float32)
    tp["audio_embed"] *= 10.0
    tp["predict"]["w"][:, 1024] *= 3.0
    save_params(tp, char / "t2s.safetensors")
    save_params(sovits.init_params(gen, SoVITSConfig(**VITS_KW), dtype=torch.float32),
                char / "vits.safetensors")
    (char / "config.json").write_text(json.dumps(
        {"version": "v2", "language": "ja", "t2s": T2S_KW, "sovits": VITS_KW}))
    hub = root / "hubert"
    hub.mkdir()
    save_params(hubert.init_params(gen, HubertConfig(**HUBERT_KW), dtype=torch.float32),
                hub / "hubert.safetensors")
    (hub / "config.json").write_text(json.dumps(HUBERT_KW))
    rng = np.random.default_rng(0)
    t = np.arange(int(3.2 * 32000)) / 32000.0
    ref = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size)
    ref_path = root / "ref.wav"
    with wave.open(str(ref_path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(32000)
        f.writeframes((ref * 32767).astype("<i2").tobytes())
    return char, hub, ref_path


def load_pair(char_dir):
    """(JAX CharacterModel, port CharacterModel) of one dir, fp32."""
    jchar = JModelManager(JRuntimeConfig(t2s_int8=False)).load_character(
        "c", str(char_dir), "Japanese", compute_dtype=jnp.float32)
    tchar = ModelManager(RuntimeConfig(t2s_int8=False)).load_character(
        "c", str(char_dir), "Japanese", compute_dtype=torch.float32, device="cpu")
    return jchar, tchar


def make_refs(jchar, tchar, jcfg, tcfg, ssl_frames=60):
    """(JAX engine, port engine, JAX ReferenceFeatures, port
    ReferenceFeatures) from the same arrays: ``ssl_frames`` stand-in HuBERT
    frames give ssl_frames/2 prompt tokens."""
    rng = np.random.default_rng(1)
    audio_32k = (rng.standard_normal(3 * 32000) * 0.1).astype(np.float32)
    ssl = rng.standard_normal((ssl_frames, 24)).astype(np.float32)
    phones = rng.integers(1, 732, 12).astype(np.int32)
    jeng, teng = jengine.TTSEngine(jcfg), tengine.TTSEngine(tcfg)
    out = []
    for eng, char, feats, ge in (
            (jeng, jchar, jengine.ReferenceFeatures,
             jeng.compute_v2_speaker_embedding(jchar, audio_32k)),
            (teng, tchar, tengine.ReferenceFeatures, tchar.synth.reference(tchar, audio_32k)["ge"])):
        out.append(feats(phones=phones, bert=np.zeros((12, 1024), np.float32),
                         prompt_tokens=eng.compute_prompt_tokens(char, ssl), ge=ge,
                         ge_mrte=ge[:16]))
    return jeng, teng, out[0], out[1]


def test_pair_loads_the_same_tensors(tmp_path):
    from genie_tts_tpu.convert.io import flatten_tree as j_flatten
    from genie_tts_tpu_torch.convert.io import flatten_tree

    jchar, tchar = load_pair(write_character(tmp_path)[0])
    assert tchar.t2s_cfg.embed_dim == jchar.t2s_cfg.embed_dim == 32
    assert tchar.sovits_cfg.upsample_rates == jchar.sovits_cfg.upsample_rates
    for jtree, ttree in ((jchar.t2s_params, tchar.t2s_params),
                         (jchar.sovits_params, tchar.sovits_params)):
        jflat, tflat = j_flatten(jtree), flatten_tree(ttree)
        assert set(jflat) == set(tflat)
        for k, v in tflat.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jflat[k]), k)
