"""The plain reference: independent of the program, and the same
functions as the program's at tiny sizes in float32."""
import subprocess
import sys

import pytest
import torch

from perfbench.harness import spec, weights
from perfbench.reference import hubert as ref_hubert, quant, roberta as ref_roberta
from perfbench.reference import sovits as ref_sovits, sv as ref_sv, t2s as ref_t2s
from perfbench.tests import tiny

sovits_config = spec.family("gpt_sovits_v2").sovits_config


def test_the_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys\n"
            "sys.path.insert(0, %r)\n"
            "import perfbench.reference, perfbench.reference.t2s, perfbench.reference.hubert\n"
            "import perfbench.reference.roberta, perfbench.reference.quant\n"
            "import perfbench.reference.sovits, perfbench.reference.sv\n"
            "import perfbench.reference.frontend.phones as ph, perfbench.reference.frontend.wordpiece\n"
            "ph.japanese('今日はいい天気ですね。'); ph.chinese('今天天气很好。')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n") % str(spec.REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not names & {"genie_tts_tpu_torch", "genie_tts_tpu", "jax", "jaxlib", "flax"}


@pytest.fixture(scope="module")
def cfg():
    c = tiny.config("gsv-v2pp-zh")
    c["dtype"] = "float32"
    return c


def test_teacher_forced_logits_are_the_programs(cfg):
    from genie_tts_tpu_torch.config import T2SConfig
    from genie_tts_tpu_torch.models import t2s

    p = weights.make("t2s", cfg, 5, "cpu")
    g = torch.Generator().manual_seed(0)
    phones = torch.randint(1, 300, (9,), generator=g)
    bert = torch.randn(9, cfg["t2s"]["bert_dim"], generator=g)
    prompts = torch.randint(0, 1024, (6,), generator=g)
    tokens = torch.randint(0, 1024, (5,), generator=g)
    z = ref_t2s.logits(p, phones, bert, prompts, tokens, cfg["t2s"]["num_heads"])
    sem = torch.cat([prompts, tokens[:-1]])[None]
    want = t2s.forward_train(p, T2SConfig(**cfg["t2s"]), phones[None], bert[None],
                             torch.tensor([9]), sem, torch.tensor([sem.shape[1]]))[0]
    assert torch.allclose(z, want[5:5 + 5], atol=1e-4, rtol=1e-4)
    ssl = torch.randn(20, cfg["t2s"]["ssl_dim"], generator=g)
    assert torch.equal(ref_t2s.prompt_tokens(p, ssl),
                       t2s.extract_prompt_tokens(p, ssl[None])[0])


def test_hubert_features_are_the_programs(cfg):
    from genie_tts_tpu_torch.config import HubertConfig
    from genie_tts_tpu_torch.models import hubert

    p = weights.make("hubert", cfg, 6, "cpu")
    audio = torch.randn(16000, generator=torch.Generator().manual_seed(1)) * 0.1
    hc = HubertConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in cfg["hubert"].items()})
    want = hubert.apply(p, audio[None], hc)[0]
    got = ref_hubert.features(p, audio, cfg["hubert"]["num_heads"])
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


def test_roberta_features_are_the_programs(cfg):
    from genie_tts_tpu_torch.config import RobertaConfig
    from genie_tts_tpu_torch.models import roberta

    p = weights.make("roberta", cfg, 7, "cpu")
    ids = [101, 800, 900, 1000, 102]
    reps = [2, 1, 3]
    want = roberta.phone_features(p, torch.tensor([ids]), torch.ones(1, 5, dtype=torch.long),
                                  torch.tensor(reps), RobertaConfig(**cfg["roberta"]))
    got = ref_roberta.phone_features(p, ids, reps, cfg["roberta"]["num_heads"],
                                     cfg["roberta"]["feature_layer"])
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def v2():
    c = tiny.config("gsv-v2-ja")
    c["dtype"] = "float32"
    return c


@pytest.mark.parametrize("n_codes, pad", [(5, 0), (9, 4)])
def test_the_synthesizer_is_the_programs(v2, n_codes, pad):
    """Latent at the prior's mean and HiFi-GAN, against the program's on a
    batch padded past the utterance (its masks keep the pad out)."""
    from genie_tts_tpu_torch.models import sovits

    vcfg = sovits_config(v2)
    p = weights.make("sovits", v2, 8, "cpu")
    g = torch.Generator().manual_seed(2)
    codes = torch.randint(0, 1024, (n_codes,), generator=g)
    phones = torch.randint(1, 300, (7,), generator=g)
    ge = torch.randn(vcfg.gin_channels, generator=g)
    ge_mrte = ge[: vcfg.mrte_channels]
    s = v2["sovits"]
    want = sovits.synthesize(
        p, vcfg, torch.cat([codes, torch.zeros(pad, dtype=torch.long)])[None],
        torch.tensor([n_codes]), torch.cat([phones, torch.zeros(3, dtype=torch.long)])[None],
        torch.tensor([7]), ge[None, :, None], ge_mrte[None, :, None], noise_scale=0.0,
        noise=torch.zeros(1, 2 * (n_codes + pad), vcfg.inter_channels))[0]
    z = ref_sovits.latent(p, codes, phones, ge, ge_mrte, s["n_heads"])
    got = ref_sovits.vocode(p, z, ge, s["upsample_rates"], s["upsample_kernels"],
                            s["resblock_kernels"], s["resblock_dilations"])
    n = 2 * n_codes * s["hop_length"]
    assert got.shape == (n,)
    assert torch.allclose(got, want[:n], atol=1e-5, rtol=1e-4)


def test_the_speaker_conditioning_is_the_programs(v2):
    from genie_tts_tpu_torch.models import prompt_encoder, sovits
    from genie_tts_tpu_torch.ops.audio import linear_spectrogram

    s = v2["sovits"]
    audio = torch.randn(4000, generator=torch.Generator().manual_seed(3)) * 0.2
    want_spec = linear_spectrogram(audio[None], s["n_fft"], s["hop_length"], s["win_length"])[0]
    spec = ref_sovits.spectrogram(audio, s["n_fft"], s["hop_length"], s["win_length"])
    assert torch.allclose(spec.T, want_spec, atol=1e-4, rtol=1e-4)
    p = weights.make("sovits", v2, 9, "cpu")
    want = sovits.reference_embedding(p, sovits_config(v2), want_spec[None],
                                      torch.tensor([want_spec.shape[0]]))[0, :, 0]
    assert torch.allclose(ref_sovits.style(p["ref_enc"], spec), want, atol=1e-5, rtol=1e-4)
    pp = tiny.config("gsv-v2pp-zh")
    pp["dtype"] = "float32"
    pe = weights.make("prompt_encoder", pp, 9, "cpu")
    emb = torch.randn(20480, generator=torch.Generator().manual_seed(4))
    want_ge, want_mrte = prompt_encoder.apply(pe, want_spec[None],
                                              torch.tensor([want_spec.shape[0]]), emb[None])
    ge, mrte = ref_sovits.prompt_encoder(pe, spec, emb)
    assert torch.allclose(ge, want_ge[0, :, 0], atol=1e-4, rtol=1e-4)
    assert torch.allclose(mrte, want_mrte[0, :, 0], atol=1e-4, rtol=1e-4)


def test_the_sv_embedding_is_the_programs():
    """ERes2NetV2 at its published widths (it has no other) over 0.4 s."""
    from genie_tts_tpu_torch.models import eres2net
    from genie_tts_tpu_torch.ops.audio import kaldi_fbank

    cfg = tiny.config("gsv-v2pp-zh")
    cfg["dtype"] = "float32"
    p = weights.make("sv", cfg, 10, "cpu")
    audio = torch.randn(6400, generator=torch.Generator().manual_seed(5)) * 0.1
    assert torch.allclose(ref_sv.fbank(audio), kaldi_fbank(audio[None])[0], atol=2e-3, rtol=1e-4)
    want = eres2net.apply(p, kaldi_fbank(audio[None]))[0]
    got = ref_sv.embedding(p, audio)
    assert got.shape == (20480,)
    assert float((got - want).norm() / want.norm()) < 1e-4


def test_greedy_gaps_by_hand():
    # V = 4, EOS = 3; prompt holds id 0; step 0 serves id 1, step 1 serves id 2
    z = torch.tensor([[2.0, 1.9, -1.0, 5.0],
                      [1.0, 1.35, 1.3, 0.0]])
    tokens = torch.tensor([1, 2])
    prompts = torch.tensor([0])
    g = ref_t2s.greedy_gaps(z, tokens, prompts, penalty=1.35, eos=3, min_steps=2)
    # step 0: id 0 penalized to 2/1.35 = 1.481 < 1.9, EOS out of reach: the best is id 1
    # step 1: ids 0, 1 penalized (1/1.35, 1.0): the best is id 2 (1.3), served
    assert g.tolist() == pytest.approx([0.0, 0.0])
    g = ref_t2s.greedy_gaps(z, torch.tensor([0, 0]), prompts, 1.35, 3, 2)
    # step 1 has seen only id 0: id 1 (1.35) is the best
    assert g.tolist() == pytest.approx([1.9 - 2.0 / 1.35, 1.35 - 1.0 / 1.35])
    choose = torch.tensor([[0.0, 0.0, 9.0, 0.0], [9.0, 0.0, 0.0, 0.0]])
    g = ref_t2s.greedy_gaps(z, tokens, prompts, 1.35, 3, 2, choose=choose)
    assert g.tolist() == pytest.approx([1.9 + 1.0, 1.3 - 1.0 / 1.35])


def test_int4_keeps_seven_levels_a_side():
    w = torch.linspace(-1, 1, 29)[:, None].repeat(1, 3)
    q = quant.fake_quant(w, 4)
    assert len(torch.unique(q[:, 0])) == 15
    assert (q - w).abs().max() <= 1.0 / 7 / 2 + 1e-6
