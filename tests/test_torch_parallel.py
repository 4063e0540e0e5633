"""The port's dp x tp sharding and train step.

* The split of every leaf path equals the JAX ``_t2s_param_spec``'s
  placement (int8 paths too); sharding and gathering give the tree back,
  and each tp rank holds the Q, K and V columns of its own heads.
* Multi-rank runs: gloo on the CPU, ranks spawned with
  ``torch.multiprocessing`` (spawn start method, a ``FileStore`` under
  ``tmp_path``): dp=2 and tp=2 in one world of 2, dp=2 x tp=2 in a world
  of 4. Each mesh takes 3 AdamW steps on a batch whose ``x_len`` and
  ``sem_len`` differ between the dp halves; the losses and the gathered
  params must match the 1 x 1 run in this process (losses rtol 1e-5,
  params relative L2 <= 1e-5 per leaf, the K bias as
  ``test_torch_train.assert_params_match`` says), and every leaf must be
  identical on the ranks that hold the same shard of it (every rank for a
  replicated leaf). Each spawn is joined with a 120 s deadline; past it,
  the ranks are killed and the test fails.
"""
import multiprocessing as mp
import pickle
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from genie_tts_tpu_torch.config import T2SConfig
from genie_tts_tpu_torch.convert.io import flatten_tree
from genie_tts_tpu_torch.models import t2s
from genie_tts_tpu_torch.parallel.mesh import (Mesh, Split, _t2s_param_spec,
                                               batch_sharding, make_mesh,
                                               merge_leaf, shard_leaf,
                                               shard_params,
                                               t2s_param_shardings)
from genie_tts_tpu_torch.parallel.train import make_batch, make_train_step

CFG = T2SConfig(phoneme_vocab=50, semantic_vocab=33, embed_dim=32, num_layers=2,
                num_heads=4, ffn_dim=64, bert_dim=16, ssl_dim=8, eos_id=32,
                max_decode_steps=8)
LR, STEPS = 1e-3, 3
JOIN_S = 120


def base_params():
    return t2s.init_params(torch.Generator().manual_seed(0), CFG, dtype=torch.float32)


def uneven_batch():
    """4 rows; the dp halves differ in x_len and sem_len."""
    b = make_batch(CFG, 4, sx=8, sy=10, seed=3)
    b["x_len"][:] = [8, 8, 5, 3]
    b["sem_len"][:] = [10, 10, 4, 7]
    return b


def train(mesh):
    init_fn, step_fn = make_train_step(CFG, mesh, learning_rate=LR)
    params, opt = init_fn(base_params())
    batch, losses = uneven_batch(), []
    for _ in range(STEPS):
        params, opt, loss = step_fn(params, opt, batch)
        losses.append(float(loss))
    return params, losses


def _rank_main(rank, world, store_path, meshes, out_dir):
    """One rank: each mesh in turn, results pickled to ``out_dir``."""
    from genie_tts_tpu_torch.parallel.mesh import gather_params

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        out = {}
        if world < 4:
            try:
                make_mesh(2, 2, devices="cpu")
            except ValueError as e:
                out["too_few"] = str(e)
        for dp, tp in meshes:
            mesh = make_mesh(dp, tp, devices="cpu")
            params, losses = train(mesh)
            out[dp, tp] = {
                "losses": losses, "tp_rank": mesh.tp_rank, "dp_rank": mesh.dp_rank,
                "local": {p: x.detach().numpy() for p, x in flatten_tree(params).items()},
                "full": {p: x.numpy() for p, x in
                         flatten_tree(gather_params(params, mesh)).items()}}
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def spawn(world, meshes, tmp_path):
    """Run ``world`` ranks; their pickled results, by rank."""
    ctx = mp.get_context("spawn")
    store = tmp_path / f"store{world}"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(store), meshes, str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p.pid for p in procs if p.is_alive()]
        assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, f"rank {r}:\n{res.get('error')}"
        assert procs[r].exitcode == 0, (r, procs[r].exitcode)
        results.append(res)
    return results


@pytest.fixture(scope="module")
def reference():
    params, losses = train(make_mesh(1, 1, devices="cpu"))
    return {p: x.detach().numpy() for p, x in flatten_tree(params).items()}, losses


def check_mesh(results, dp, tp, reference):
    from test_torch_train import assert_params_match

    ref_params, ref_losses = reference
    runs = [r[dp, tp] for r in results]
    for run in runs:
        np.testing.assert_allclose(run["losses"], ref_losses, rtol=1e-5)
        assert_params_match(run["full"], ref_params, lr=LR, steps=STEPS)
    assert ref_losses[-1] < ref_losses[0]
    # the ranks that hold the same shard of a leaf hold the same values;
    # a replicated leaf is the same on every rank
    for path in runs[0]["local"]:
        split = _t2s_param_spec(path)
        for run in runs[1:]:
            if split is None or run["tp_rank"] == runs[0]["tp_rank"]:
                assert np.array_equal(run["local"][path], runs[0]["local"][path]), \
                    (dp, tp, path)
        for run in runs:                       # every shard is its slice of the whole
            np.testing.assert_array_equal(
                run["local"][path],
                shard_leaf(torch.as_tensor(run["full"][path]), split, tp,
                           run["tp_rank"]).numpy())


def test_dp2_and_tp2_match_one_device(tmp_path, reference):
    results = spawn(2, [(2, 1), (1, 2)], tmp_path)
    for res in results:
        assert res["too_few"] == "mesh 2x2 needs 4 devices, have 2"
    check_mesh(results, 2, 1, reference)
    check_mesh(results, 1, 2, reference)


def test_dp2_tp2_matches_one_device(tmp_path, reference):
    results = spawn(4, [(2, 2)], tmp_path)
    assert sorted((r[2, 2]["dp_rank"], r[2, 2]["tp_rank"]) for r in results) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    check_mesh(results, 2, 2, reference)


def test_specs_match_jax_rule_table():
    """Every path of a float and an int8 tree, against the JAX rule table
    (``P(...)`` -> the axis that names tp)."""
    from genie_tts_tpu.parallel.mesh import TP_AXIS as J_TP
    from genie_tts_tpu.parallel.mesh import _t2s_param_spec as j_spec

    params = base_params()
    paths = list(flatten_tree(params)) + list(flatten_tree(t2s.quantize_params(params)))
    assert any(p.endswith("qkv/scale") for p in paths)
    for path in paths:
        spec = tuple(j_spec(path))
        want = spec.index(J_TP) if J_TP in spec else None
        got = _t2s_param_spec(path)
        assert (got.axis if got else None) == want, path
        if got:
            assert got.parts == (3 if "/qkv/" in path else 1), path
    specs = flatten_tree(t2s_param_shardings(params, None))
    assert specs["layers/qkv/w"] == Split(2, 3) and specs["layers/ffn2/w"] == Split(1)
    assert specs["text_embed"] is None


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_and_gather_give_the_tree_back(tp):
    params = t2s.quantize_params(base_params()) if tp == 4 else base_params()
    shards = [shard_params(params, Mesh(1, tp, torch.device("cpu"), 0, r))[0]
              for r in range(tp)]
    full = flatten_tree(params)
    for path, x in full.items():
        split = _t2s_param_spec(path)
        got = merge_leaf([flatten_tree(s)[path] for s in shards], split)
        assert torch.equal(got, x), path
    # qkv columns of rank r: Q | K | V of heads [r*H/tp, (r+1)*H/tp)
    D, H = CFG.embed_dim, CFG.num_heads
    dh, hl = D // H, H // tp
    w = full["layers/qkv/w"]
    for r, s in enumerate(shards):
        heads = [slice((r * hl) * dh, (r + 1) * hl * dh)]
        want = torch.cat([w[..., i * D:(i + 1) * D][..., heads[0]] for i in range(3)], -1)
        assert torch.equal(s["layers"]["qkv"]["w"], want)
        want_b = torch.cat([full["layers/qkv/b"][..., i * D:(i + 1) * D][..., heads[0]]
                            for i in range(3)], -1)
        assert torch.equal(s["layers"]["qkv"]["b"], want_b)
        assert torch.equal(s["layers"]["out"]["w"],
                           full["layers/out/w"][:, heads[0]])
        assert torch.equal(s["layers"]["ffn1"]["w"],
                           full["layers/ffn1/w"].chunk(tp, -1)[r])
        assert torch.equal(s["layers"]["ffn2"]["w"],
                           full["layers/ffn2/w"].chunk(tp, 1)[r])
        assert s["layers"]["out"]["b"] is full["layers/out/b"]


def test_mesh_and_batch_checks():
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices, have 1"):
        make_mesh(2, 2, devices="cpu")
    mesh = make_mesh(1, 1, devices="cpu")
    assert (mesh.dp, mesh.tp, mesh.device) == (1, 1, torch.device("cpu"))
    rows = batch_sharding(Mesh(2, 1, torch.device("cpu"), 1, 0))
    np.testing.assert_array_equal(rows(np.arange(6)), [3, 4, 5])
    with pytest.raises(ValueError, match="does not split over dp=2"):
        rows(np.arange(5))
    with pytest.raises(ValueError, match="must divide num_heads"):
        make_train_step(CFG, Mesh(1, 3, torch.device("cpu")))
    with pytest.raises(ValueError, match="does not split"):
        shard_leaf(torch.zeros(2, 8, 30), Split(2, 3), 4, 0)
