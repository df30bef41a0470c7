"""The rest of the port's ``incubate`` (``asp``, ``optimizer``, the top
level) and ``geometric`` against the JAX package's, on the CPU.

- asp: the 1-d, 2-d greedy and 2-d best masks equal JAX's on the same
  seeded matrices (ties included), ``create_mask`` at ranks 1-4,
  ``check_sparsity`` and ``calculate_density``; ``prune_model`` (mask_1d
  through the device path, mask_2d_best through the host path, an
  excluded layer) gives JAX's pruned weights exactly, and a
  ``decorate``d optimizer keeps the 2:4 sparsity over steps with the
  weights equal to JAX's to 1e-6;
- LookAhead (over SGD and Adam), ModelAverage (apply / restore, window
  rolls) and DistributedFusedLamb: the parameters along 6 steps equal
  JAX's to 1e-6 of their size (float32), state dicts round-trip;
- the incubate top level: its public names are JAX's,
  ``softmax_mask_fuse_upper_triangle``, ``identity_loss``,
  ``graph_khop_sampler`` (whole neighborhoods: deterministic);
- geometric: every case of ``ops_sweep_torch.INCUBATE`` (the message
  passing and segment ops, and the quantization and MoE ops, float64 to
  1e-10, float32 to 1e-5, with gradients where marked), ``send_uv``, the
  reindexing (exact), and the samplers: whole neighborhoods exact,
  capped samples by their rule (the seed is the port's draw, not JAX's).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.geometric as JG
import paddle_tpu.incubate as JINC
import paddle_tpu.quantization  # noqa: F401  (registers its ops)
from paddle_tpu.incubate import asp as jasp
from paddle_tpu.incubate.distributed import moe_layer as jml

import paddle_tpu_torch as ptt
import paddle_tpu_torch.geometric as TG
import paddle_tpu_torch.incubate as TINC
import paddle_tpu_torch.quantization.quant  # noqa: F401
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.incubate import asp as tasp
from paddle_tpu_torch.incubate.distributed import moe_layer as tml
from torch_parity import (SWEEP, case_id, check, check_grad,  # noqa: F401
                          cpu_device, rng)

torch.set_num_threads(1)
# the MoE balance loss registers its op at its first call, in both packages
jml.load_balance_loss(paddle.zeros([2, 2]))
tml.load_balance_loss(torch.zeros(2, 2))


# -- asp ----------------------------------------------------------------------

def _tied(seed, shape):
    """A matrix with many equal magnitudes (ties inside groups)."""
    r = rng(seed)
    return (r.integers(-3, 4, shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("fn", ["get_mask_1d", "get_mask_2d_greedy",
                                "get_mask_2d_best"])
@pytest.mark.parametrize("shape", [(8, 8), (12, 10)])
@pytest.mark.parametrize("tied", [False, True])
def test_masks_equal_jax(fn, shape, tied):
    w = _tied(1, shape) if tied else rng(1).standard_normal(shape).astype(
        np.float32)
    want = getattr(jasp, fn)(w, 2, 4)
    got = getattr(tasp, fn)(w, 2, 4)
    np.testing.assert_array_equal(got, want)
    check_fn = "check_mask_1d" if fn.endswith("1d") else "check_mask_2d"
    assert getattr(tasp, check_fn)(w * got) == getattr(jasp, check_fn)(
        w * want) is True


@pytest.mark.parametrize("shape", [(10,), (6, 8), (3, 4, 8), (3, 3, 8, 6)])
@pytest.mark.parametrize("algo", ["mask_1d", "mask_2d_best"])
def test_create_mask_and_checks_equal_jax(shape, algo):
    w = rng(2).standard_normal(shape).astype(np.float32)
    want = jasp.create_mask(w, algo)
    got = tasp.create_mask(torch.from_numpy(w), algo)
    np.testing.assert_array_equal(got, want)
    for method in ("check_1d", "check_2d"):
        if len(shape) < 2 and method == "check_2d":
            continue
        for arr in (w, w * want):
            assert tasp.check_sparsity(torch.from_numpy(arr), method) == \
                jasp.check_sparsity(arr, method)
            assert tasp.check_sparsity(arr, method) == \
                jasp.check_sparsity(arr, method)
    assert tasp.calculate_density(torch.from_numpy(w * want)) == \
        jasp.calculate_density(w * want)


def _mlp_pair(seed):
    paddle.seed(seed)
    jnet = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.ReLU(),
                                paddle.nn.Linear(32, 8))
    tnet = tnn.Sequential(tnn.Linear(16, 32, device="cpu"), tnn.ReLU(),
                          tnn.Linear(32, 8, device="cpu"))
    weights.from_paddle_tpu_state(
        {n: np.asarray(p._value, np.float32)
         for n, p in jnet.named_parameters()}, tnet)
    return jnet, tnet


def _params_close(tnet, jnet, rel=1e-6):
    jp = dict(jnet.named_parameters())
    for n, p in tnet.named_parameters():
        want = np.asarray(jp[n].numpy())
        got = p.detach().numpy()
        err = np.abs(got - want).max()
        assert err <= rel * max(np.abs(want).max(), 1e-30), (n, err)


@pytest.mark.parametrize("algo", ["mask_1d", "mask_2d_best"])
def test_prune_and_decorated_steps_match_jax(algo):
    jnet, tnet = _mlp_pair(5)
    jasp.set_excluded_layers(["2"])
    tasp.set_excluded_layers(["2"])
    try:
        jasp.prune_model(jnet, mask_algo=algo)
        tasp.prune_model(tnet, mask_algo=algo)
    finally:
        jasp.reset_excluded_layers()
        tasp.reset_excluded_layers()
    _params_close(tnet, jnet, 0.0)
    assert tasp.calculate_density(tnet[0].weight) == 0.5
    assert tasp.calculate_density(tnet[2].weight) == 1.0   # excluded
    jo = jasp.decorate(paddle.optimizer.Adam(
        0.01, parameters=jnet.parameters()))
    to = tasp.decorate(topt.Adam(0.01, parameters=tnet.parameters()))
    assert tasp.decorate(to) is to
    r = rng(6)
    for _ in range(3):
        x = r.standard_normal((4, 16)).astype(np.float32)
        (jnet(paddle.to_tensor(x)) ** 2).mean().backward()
        (tnet(torch.from_numpy(x)) ** 2).mean().backward()
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        method = "check_1d" if algo == "mask_1d" else "check_2d"
        assert tasp.check_sparsity(tnet[0].weight, method)
        assert tasp.calculate_density(tnet[0].weight) == 0.5
    _params_close(tnet, jnet)
    sd = to.state_dict()
    to.set_state_dict(sd)


# -- the incubate optimizers ------------------------------------------------------

def _opt_pair(kind, jnet, tnet):
    if kind == "lookahead-sgd":
        return (JINC.LookAhead(paddle.optimizer.SGD(
                    0.1, parameters=jnet.parameters()), alpha=0.5, k=2),
                TINC.LookAhead(topt.SGD(
                    0.1, parameters=tnet.parameters()), alpha=0.5, k=2))
    if kind == "lookahead-adam":
        return (JINC.LookAhead(paddle.optimizer.Adam(
                    0.01, parameters=jnet.parameters()), alpha=0.8, k=3),
                TINC.LookAhead(topt.Adam(
                    0.01, parameters=tnet.parameters()), alpha=0.8, k=3))
    return (JINC.DistributedFusedLamb(0.01, parameters=jnet.parameters()),
            TINC.DistributedFusedLamb(0.01, parameters=tnet.parameters()))


@pytest.mark.parametrize("kind", ["lookahead-sgd", "lookahead-adam",
                                  "lamb"])
def test_optimizer_trajectories_match_jax(kind):
    jnet, tnet = _mlp_pair(7)
    jo, to = _opt_pair(kind, jnet, tnet)
    r = rng(8)
    for step in range(6):
        x = r.standard_normal((4, 16)).astype(np.float32)
        jo.minimize((jnet(paddle.to_tensor(x)) ** 2).mean()) \
            if kind != "lamb" else None
        if kind == "lamb":
            (jnet(paddle.to_tensor(x)) ** 2).mean().backward()
            jo.step()
            jo.clear_grad()
            (tnet(torch.from_numpy(x)) ** 2).mean().backward()
            to.step()
            to.clear_grad()
        else:
            to.minimize((tnet(torch.from_numpy(x)) ** 2).mean())
        _params_close(tnet, jnet, 2e-6)
    if kind != "lamb":
        sd = to.state_dict()
        assert sd["lookahead_step"] == 6
        fresh = TINC.LookAhead(topt.SGD(0.1, parameters=tnet.parameters()))
        fresh.set_state_dict(sd)
        assert fresh._step_num == 6 and len(fresh._slow) == len(
            list(tnet.parameters()))


def test_model_average_matches_jax():
    jnet, tnet = _mlp_pair(9)
    jsgd = paddle.optimizer.SGD(0.1, parameters=jnet.parameters())
    tsgd = topt.SGD(0.1, parameters=tnet.parameters())
    jma = JINC.ModelAverage(0.5, parameters=jnet.parameters(),
                            min_average_window=2, max_average_window=3)
    tma = TINC.ModelAverage(0.5, parameters=tnet.parameters(),
                            min_average_window=2, max_average_window=3)
    r = rng(10)
    for _ in range(5):
        x = r.standard_normal((4, 16)).astype(np.float32)
        (jnet(paddle.to_tensor(x)) ** 2).mean().backward()
        (tnet(torch.from_numpy(x)) ** 2).mean().backward()
        jsgd.step()
        tsgd.step()
        jsgd.clear_grad()
        tsgd.clear_grad()
        jma.step()
        tma.step()
    assert (tma._n_cur, tma._n_prev) == (jma._n_cur, jma._n_prev)
    before = {n: p.detach().clone() for n, p in tnet.named_parameters()}
    with tma, jma:
        _params_close(tnet, jnet, 2e-6)
        assert any(not torch.equal(p, before[n])
                   for n, p in tnet.named_parameters())
    for n, p in tnet.named_parameters():
        assert torch.equal(p, before[n])
    _params_close(tnet, jnet, 2e-6)
    sd = tma.state_dict()
    other = TINC.ModelAverage(0.5, parameters=tnet.parameters())
    other.set_state_dict(sd)
    assert other._total == 5
    with pytest.raises(RuntimeError):
        tma.minimize()


# -- the incubate top level -------------------------------------------------------

def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_incubate_top_level_names_and_functions():
    missing = _public(JINC) - _public(TINC)
    # the JAX module's own imports of numpy-free helpers are names too
    assert missing == set(), sorted(missing)
    x = rng(11).standard_normal((2, 3, 5, 5)).astype(np.float32)
    check_pair = (TINC.softmax_mask_fuse_upper_triangle(torch.from_numpy(x)),
                  JINC.softmax_mask_fuse_upper_triangle(paddle.to_tensor(x)))
    np.testing.assert_allclose(check_pair[0].numpy(),
                               np.asarray(check_pair[1].numpy()), rtol=1e-6,
                               atol=1e-7)
    for red in ("none", "sum", "mean"):      # float32 sums: 1e-5
        np.testing.assert_allclose(
            TINC.identity_loss(torch.from_numpy(x), red).numpy(),
            np.asarray(JINC.identity_loss(paddle.to_tensor(x), red)
                       .numpy()), rtol=1e-5)
    assert TINC.graph_send_recv is TG.send_u_recv
    assert TINC.graph_reindex is TG.reindex_graph


# -- geometric (and the table of the quantization and MoE ops) --------------------

CASES = SWEEP.INCUBATE.CASES


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_op_matches_jax(case):
    name, args, kwargs, opts = case
    check(name, args, kwargs, tol=opts.get("tol"))


GRAD_CASES = [c for c in CASES if c[3].get("grad")]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[case_id(c) for c in GRAD_CASES])
def test_op_grad_matches_jax(case):
    name, args, kwargs, opts = case
    check_grad(name, args, kwargs,
               tol=(2e-5, 2e-6) if opts.get("tol") else (1e-9, 1e-11),
               diff=opts.get("diff"))


def _graph():
    """A CSC graph of 6 nodes: colptr, row (the in-neighbors), weights."""
    colptr = np.array([0, 2, 5, 5, 8, 9, 12], np.int64)
    row = np.array([1, 3, 0, 2, 4, 1, 2, 5, 0, 1, 3, 4], np.int64)
    w = rng(12).uniform(0.1, 2.0, 12).astype(np.float32)
    return row, colptr, w


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_send_uv_matches_jax(op):
    r = rng(13)
    x = r.standard_normal((5, 3))
    y = r.uniform(0.5, 2.0, (5, 3))
    src, dst = np.array([0, 1, 4, 2]), np.array([3, 3, 0, 1])
    want = JG.send_uv(paddle.to_tensor(x), paddle.to_tensor(y), src, dst, op)
    got = TG.send_uv(torch.from_numpy(x), torch.from_numpy(y), src, dst, op)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-12)


def test_reindex_matches_jax():
    x = np.array([4, 0, 7], np.int64)
    nb = np.array([7, 2, 0, 9, 9, 4, 1], np.int64)
    cnt = np.array([3, 2, 2], np.int32)
    want = JG.reindex_graph(paddle.to_tensor(x), paddle.to_tensor(nb),
                            paddle.to_tensor(cnt))
    got = TG.reindex_graph(torch.from_numpy(x), torch.from_numpy(nb),
                           torch.from_numpy(cnt))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w.numpy()))
    nbs = [nb, np.array([5, 4], np.int64)]
    cnts = [cnt, np.array([1, 0, 1], np.int32)]
    want = JG.reindex_heter_graph(x, nbs, cnts)
    got = TG.reindex_heter_graph(torch.from_numpy(x), nbs, cnts)
    for gs, ws in zip(got[:2], want[:2]):
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w.numpy()))
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.asarray(want[2].numpy()))


def test_samplers_match_jax_on_whole_neighborhoods():
    row, colptr, w = _graph()
    nodes = np.array([0, 1, 2, 3, 5], np.int64)
    eids = np.arange(12, dtype=np.int64) + 100
    for size in (-1, 3):
        want = JG.sample_neighbors(row, colptr, nodes, sample_size=size,
                                   eids=eids, return_eids=True)
        got = TG.sample_neighbors(row, colptr, torch.from_numpy(nodes),
                                  sample_size=size, eids=eids,
                                  return_eids=True)
        for g, v in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(v.numpy()))
        want = JG.weighted_sample_neighbors(row, colptr, w, nodes,
                                            sample_size=size)
        got = TG.weighted_sample_neighbors(row, colptr, w,
                                           torch.from_numpy(nodes),
                                           sample_size=size)
        for g, v in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(v.numpy()))
    want = JINC.graph_khop_sampler(row, colptr, nodes[:2], [-1, -1])
    got = TINC.graph_khop_sampler(row, colptr, torch.from_numpy(nodes[:2]),
                                  [-1, -1])
    for g, v in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(v.numpy()))


def test_capped_samples_keep_the_rule():
    row, colptr, w = _graph()
    nodes = torch.tensor([1, 3, 5])
    ptt.seed(3)
    a, ca = TG.sample_neighbors(row, colptr, nodes, sample_size=2)
    ptt.seed(3)
    b, cb = TG.sample_neighbors(row, colptr, nodes, sample_size=2)
    assert torch.equal(a, b) and ca.tolist() == [2, 2, 2]
    assert ca.dtype == torch.int32
    starts = [0, 2, 4]
    for v, s in zip(nodes.tolist(), starts):
        pick = a[s:s + 2].tolist()
        assert len(set(pick)) == 2
        assert set(pick) <= set(row[colptr[v]:colptr[v + 1]].tolist())
    c, cc = TG.weighted_sample_neighbors(row, colptr, w, nodes,
                                         sample_size=1)
    assert cc.tolist() == [1, 1, 1]
