"""The port's multi-process world on the CPU: real processes started by
the port's launch CLI (``python -m paddle_tpu_torch.distributed.launch``),
joined by ``init_parallel_env`` over ``torch.distributed`` and gloo on the
loopback (a free port chosen by the test), against numpy and the JAX
package's runs on the same inputs.

Each world is started once for the module (a fixture) and its workers
write what they computed; the tests read it. Tolerances: the collectives
exactly (float32 sums of two or four values, the same order as numpy's);
the losses rtol 1e-5 (the JAX test's, ``tests/test_multihost.py:120``),
1e-4 for the dp x mp MLP (``tests/test_multihost_hybrid.py:154``); the
ring and Ulysses across processes 1e-5 of the JAX ring on a 2-device
mesh. The per-rank optimizer-state bytes are held against the port's
single controller, which the JAX package has no counterpart of."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import jit as jjit
from paddle_tpu import nn as jnn
from paddle_tpu.ops import ring_attention as jring

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights as tweights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tiny MLP of tests/test_multihost.py: 8 rows of 8 features, 4 classes
MLP_SEED = 7
SGD_LR = 0.1
ADAM_LR = 0.01
STEPS = 3
RING = dict(b=1, s=16, h=4, d=8)

_COMMON = r'''
import json, os, sys
import numpy as np
import torch
sys.path.insert(0, os.environ["MP_REPO"])
import paddle_tpu_torch as ptt
ptt.set_device("cpu")
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import multihost
from paddle_tpu_torch.distributed import parallel_base as pb
OUT = os.environ["MP_DIR"]
dist.init_parallel_env()
rank, world = dist.get_rank(), dist.get_world_size()
res, arrs = {}, {}


def finish():
    res["proc_calls"] = {k: v["calls"] for k, v in pb.proc_stats().items()}
    json.dump(res, open(os.path.join(OUT, f"res.{rank}.json"), "w"))
    np.savez(os.path.join(OUT, f"arr.{rank}.npz"), **arrs)
    dist.barrier()
    dist.destroy_process_group()
    print("WORKER_DONE", flush=True)
'''

WORKER2 = _COMMON + r'''
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch import weights
from paddle_tpu_torch.ops import ring_attention as ring

res["world"] = [rank, world, multihost.process_count(),
                multihost.process_index(), dist.get_backend(),
                dist.is_initialized(), dist.ParallelEnv().nranks]
res["reduce_value"] = [float(multihost.all_reduce_value(float(rank + 1), op))
                       for op in ("sum", "max", "min", "mean")]

# ---- every collective on seeded inputs ----
def mine(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed + rank)
                            .standard_normal(shape).astype("float32"))

for op in ("sum", "max", "min", "prod", "avg"):
    t = mine(100, (4, 3))
    dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()))
    arrs[f"all_reduce_{op}"] = t.numpy()
got = []
dist.all_gather(got, mine(100, (4, 3)))
arrs["all_gather"] = np.stack([g.numpy() for g in got])
t = mine(100, (4, 3))
dist.broadcast(t, src=1)
arrs["broadcast"] = t.numpy()
t = mine(100, (4, 3))
dist.reduce(t, dst=0)
if rank == 0:
    arrs["reduce"] = t.numpy()
t = torch.empty(4, 3)
dist.scatter(t, [mine(200, (4, 3)) + i for i in range(world)]
             if rank == 0 else None, src=0)
arrs["scatter"] = t.numpy()
t = torch.empty(4, 3)
dist.reduce_scatter(t, [mine(300 + 10 * i, (4, 3)) for i in range(world)])
arrs["reduce_scatter_list"] = t.numpy()
t = torch.empty(2, 3)
dist.reduce_scatter(t, mine(400, (2 * world, 3)))
arrs["reduce_scatter_tensor"] = t.numpy()
got = []
dist.alltoall(got, [mine(500 + 10 * i, (4, 3)) for i in range(world)])
arrs["alltoall"] = np.stack([g.numpy() for g in got])
t = torch.empty(2 * world, 3)
dist.alltoall_single(t, mine(600, (2 * world, 3)))
arrs["alltoall_single"] = t.numpy()
if rank == 0:
    dist.send(mine(700, (4, 3)), 1)
else:
    t = torch.empty(4, 3)
    dist.recv(t, 0)
    arrs["send_recv"] = t.numpy()
t = torch.empty(4, 3)
tasks = [dist.isend(mine(800, (4, 3)), 1 - rank), dist.irecv(t, 1 - rank)]
for task in tasks:
    task.wait()
arrs["isend_irecv"] = t.numpy()
got = dist.gather(mine(100, (4, 3)))
arrs["gather"] = np.stack([g.numpy() for g in got])
objs = []
dist.all_gather_object(objs, {"rank": rank})
res["all_gather_object"] = objs
objs = [rank, "r%d" % rank]
dist.broadcast_object_list(objs, src=1)
res["broadcast_object_list"] = objs
objs = []
dist.scatter_object_list(objs, [["a"], ["b"]] if rank == 0 else None, src=0)
res["scatter_object_list"] = objs
g = dist.new_group([0, 1])
t = mine(100, (4, 3))
dist.all_reduce(t, group=g)
arrs["new_group_all_reduce"] = t.numpy()
res["group_rank"] = g.rank
dist.barrier()

# ---- the tiny MLP: DataParallel + SGD, then ZeRO 1 and 2 + AdamW ----
inp = np.load(os.path.join(OUT, "inputs.npz"))
X = torch.from_numpy(inp["X"])[rank * 4:(rank + 1) * 4]
Y = torch.from_numpy(inp["Y"])[rank * 4:(rank + 1) * 4]
state = {k[2:]: inp[k] for k in inp.files if k.startswith("w.")}


def mlp():
    net = nn.Sequential(nn.Linear(8, 16, device="cpu"), nn.Tanh(),
                        nn.Linear(16, 4, device="cpu"))
    return weights.from_paddle_tpu_state(state, net)


def run(zero=None):
    net = mlp()
    dp = dist.DataParallel(net)
    if zero is None:
        opt = optimizer.SGD(float(inp["sgd_lr"]), parameters=net.parameters())
    else:
        opt = optimizer.AdamW(float(inp["adam_lr"]),
                              parameters=net.parameters())
        mesh = dist.ProcessMesh([0, 1], ["dp"])
        stage = {1: dist.ShardingStage1, 2: dist.ShardingStage2,
                 3: dist.ShardingStage3}[zero]
        dist.shard_optimizer(opt, stage("dp", mesh))
    lossfn = nn.CrossEntropyLoss()
    losses = []
    for _ in range(int(inp["steps"])):
        loss = lossfn(dp(X), Y)
        loss.backward()
        opt.step()
        freed = all(p.grad is None for p in net.parameters())
        opt.clear_grad()
        losses.append(float(multihost.all_reduce_value(float(loss), "mean")))
    out = {"losses": losses}
    if zero is not None:
        out["state_bytes"] = opt._zero.state_bytes()
        out["grads_freed"] = freed
    return out

res["sgd"] = run()
res["zero1"] = run(1)
res["zero2"] = run(2)
res["zero3"] = run(3)

# ---- ring and Ulysses across the two processes ----
for name, fn, axis in (("ring", ring.ring_flash_attention, "sp"),
                       ("ulysses", ring.ulysses_attention, "sep")):
    mesh = dist.ProcessMesh([0, 1], [axis])
    for causal in (True, False):
        q, k, v, w = (torch.from_numpy(inp[f"attn.{x}"]) for x in "qkvw")
        sl = q.shape[1] // world
        piece = lambda t: t[:, rank * sl:(rank + 1) * sl].clone() \
            .requires_grad_()
        ql, kl, vl = piece(q), piece(k), piece(v)
        out = fn(ql, kl, vl, mesh, axis, causal=causal)
        (out * w[:, rank * sl:(rank + 1) * sl]).sum().backward()
        tag = f"{name}_{int(causal)}"
        arrs[tag + "_out"] = out.detach().numpy()
        for x, t in (("dq", ql), ("dk", kl), ("dv", vl)):
            arrs[f"{tag}_{x}"] = t.grad.numpy()
finish()
'''

WORKER4 = _COMMON + r'''
# dp 2 x mp 2 over new_group subgroups: rank = 2 * dp + mp
dp_i, mp_j = divmod(rank, 2)
mp_groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
dp_groups = [dist.new_group([0, 2]), dist.new_group([1, 3])]
mp_g, dp_g = mp_groups[dp_i], dp_groups[mp_j]
inp = np.load(os.path.join(OUT, "inputs4.npz"))
w1 = torch.from_numpy(inp["W1"][:, mp_j * 8:(mp_j + 1) * 8].copy())
w2 = torch.from_numpy(inp["W2"][mp_j * 8:(mp_j + 1) * 8].copy())
x = torch.from_numpy(inp["X"][dp_i * 4:(dp_i + 1) * 4].copy())
y = torch.from_numpy(inp["Y"][dp_i * 4:(dp_i + 1) * 4].copy())
w1.requires_grad_()
w2.requires_grad_()
res["shapes"] = [list(w1.shape), list(x.shape)]
losses = []
for _ in range(4):
    h = torch.relu(x @ w1)                   # column-parallel
    part = h @ w2                            # row-parallel partial sum
    full = part.detach().clone()
    dist.all_reduce(full, group=mp_g)        # the mp sum
    out = part + (full - part.detach())      # its backward is the identity
    loss = ((out - y) ** 2).mean() / 2       # this dp rank's half
    loss.backward()
    total = loss.detach().clone()
    dist.all_reduce(total, group=dp_g)
    losses.append(float(total))
    with torch.no_grad():
        for p in (w1, w2):
            dist.all_reduce(p.grad, group=dp_g)
            p -= 0.1 * p.grad
            p.grad = None
res["losses"] = losses
finish()
'''


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(tmp, script, n, timeout=240):
    """Start n workers through the port's launch CLI and wait for them;
    returns each rank's (results, arrays)."""
    port = _free_port()
    w = tmp / "worker.py"
    w.write_text(script)
    env = dict(os.environ, MP_DIR=str(tmp), MP_REPO=REPO,
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nnodes", str(n), "--rank", str(r), "--master",
         f"127.0.0.1:{port}", "--log_dir", str(tmp / f"log{r}"), str(w)],
        cwd=REPO, env=env) for r in range(n)]
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = {r: (tmp / f"log{r}" / f"workerlog.{r}.0").read_text()
            for r in range(n) if (tmp / f"log{r}" / f"workerlog.{r}.0")
            .exists()}
    assert codes == [0] * n, (codes, {r: lg[-3000:] for r, lg in
                                      logs.items()})
    return [(json.load(open(tmp / f"res.{r}.json")),
             dict(np.load(tmp / f"arr.{r}.npz"))) for r in range(n)]


def _jax_mlp():
    paddle.seed(MLP_SEED)
    np.random.seed(MLP_SEED)
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    X = np.random.rand(8, 8).astype("float32")
    Y = np.random.randint(0, 4, 8).astype("int64")
    return net, X, Y


def _rank_inputs(seed, shape, n=2):
    return [np.random.default_rng(seed + r).standard_normal(shape)
            .astype("float32") for r in range(n)]


@pytest.fixture(autouse=True)
def _cpu():
    """The CPU as the current device; the previous one back after."""
    prev = tdevice._CURRENT[0]
    ptt.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


@pytest.fixture(scope="module")
def mlp_case():
    net, X, Y = _jax_mlp()
    state = {k: np.asarray(v.numpy()).copy()
             for k, v in net.state_dict().items()}
    o = jopt.SGD(SGD_LR, parameters=net.parameters())
    lossfn = jnn.CrossEntropyLoss()
    step = jjit.compile_train_step(net, lambda m, a, b: lossfn(m(a), b), o)
    serial = [float(step(paddle.to_tensor(X), paddle.to_tensor(Y)).numpy())
              for _ in range(STEPS)]
    return state, X, Y, serial


@pytest.fixture(scope="module")
def attn_inputs():
    rng = np.random.default_rng(5)
    shape = (RING["b"], RING["s"], RING["h"], RING["d"])
    return {x: rng.standard_normal(shape).astype("float32") for x in "qkvw"}


@pytest.fixture(scope="module")
def world2(tmp_path_factory, mlp_case, attn_inputs):
    tmp = tmp_path_factory.mktemp("world2")
    state, X, Y, _ = mlp_case
    np.savez(tmp / "inputs.npz", X=X, Y=Y, sgd_lr=SGD_LR, adam_lr=ADAM_LR,
             steps=STEPS, **{f"w.{k}": v for k, v in state.items()},
             **{f"attn.{k}": v for k, v in attn_inputs.items()})
    return _launch(tmp, WORKER2, 2)


def test_world_and_all_reduce_value(world2):
    for r, (res, _) in enumerate(world2):
        assert res["world"] == [r, 2, 2, r, "gloo", True, 2]
        assert res["reduce_value"] == [3.0, 2.0, 1.0, 1.5]
        assert res["group_rank"] == r
        assert res["all_gather_object"] == [{"rank": 0}, {"rank": 1}]
        assert res["broadcast_object_list"] == [1, "r1"]
    assert world2[0][0]["scatter_object_list"] == [["a"]]
    assert world2[1][0]["scatter_object_list"] == [["b"]]


def _want(name):
    a = _rank_inputs(100, (4, 3))
    if name.startswith("all_reduce_"):
        op = name[len("all_reduce_"):]
        f = {"sum": lambda: a[0] + a[1], "max": lambda: np.maximum(*a),
             "min": lambda: np.minimum(*a), "prod": lambda: a[0] * a[1],
             "avg": lambda: (a[0] + a[1]) / np.float32(2)}[op]
        return [f(), f()]
    if name in ("all_gather", "gather"):
        return [np.stack(a)] * 2
    if name == "broadcast":
        return [a[1], a[1]]
    if name == "new_group_all_reduce":
        return [a[0] + a[1]] * 2
    if name == "reduce":
        return [a[0] + a[1], None]
    if name == "scatter":
        c = _rank_inputs(200, (4, 3))[0]
        return [c, c + 1]
    if name == "reduce_scatter_list":
        b = [_rank_inputs(300 + 10 * i, (4, 3)) for i in range(2)]
        return [b[0][0] + b[0][1], b[1][0] + b[1][1]]
    if name == "reduce_scatter_tensor":
        t = _rank_inputs(400, (4, 3))
        s = t[0] + t[1]
        return [s[:2], s[2:]]
    if name == "alltoall":
        e = [_rank_inputs(500 + 10 * i, (4, 3)) for i in range(2)]
        return [np.stack([e[0][0], e[0][1]]), np.stack([e[1][0], e[1][1]])]
    if name == "alltoall_single":
        i = _rank_inputs(600, (4, 3))
        return [np.concatenate([i[0][:2], i[1][:2]]),
                np.concatenate([i[0][2:], i[1][2:]])]
    if name == "send_recv":
        return [None, _rank_inputs(700, (4, 3))[0]]
    if name == "isend_irecv":
        s = _rank_inputs(800, (4, 3))
        return [s[1], s[0]]
    raise KeyError(name)


COLLECTIVES = ["all_reduce_sum", "all_reduce_max", "all_reduce_min",
               "all_reduce_prod", "all_reduce_avg", "all_gather",
               "broadcast", "reduce", "scatter", "reduce_scatter_list",
               "reduce_scatter_tensor", "alltoall", "alltoall_single",
               "send_recv", "isend_irecv", "gather", "new_group_all_reduce"]


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_against_numpy(world2, name):
    """Each collective across the two processes against numpy on the
    same seeded inputs (exact: two float32 values combine in one
    rounding, as numpy's)."""
    for r, want in enumerate(_want(name)):
        if want is None:
            continue
        np.testing.assert_array_equal(world2[r][1][name], want)


def test_proc_stats_count_the_calls(world2):
    for res, _ in world2:
        calls = res["proc_calls"]
        assert calls["all_reduce"] >= 6 and calls["reduce_scatter"] >= 2
        assert calls["alltoall"] == 1 and calls["alltoall_single"] >= 1


def test_mlp_sgd_losses_match_jax_serial(world2, mlp_case):
    """DataParallel over two processes, each on its half of the batch:
    the mean loss of the 3 SGD steps against the JAX package's serial run
    over the whole batch (rtol 1e-5, tests/test_multihost.py:120)."""
    serial = mlp_case[3]
    for res, _ in world2:
        np.testing.assert_allclose(res["sgd"]["losses"], serial, rtol=1e-5,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def jax_adamw_serial():
    """The JAX package's serial run: the same MLP (the same seeded
    initial weights as ``mlp_case``'s), AdamW over the whole batch."""
    net, X, Y = _jax_mlp()
    o = jopt.AdamW(ADAM_LR, parameters=net.parameters())
    lossfn = jnn.CrossEntropyLoss()
    init = {k: np.asarray(v.numpy()).copy()
            for k, v in net.state_dict().items()}
    step = jjit.compile_train_step(net, lambda m, a, b: lossfn(m(a), b), o)
    return init, [float(step(paddle.to_tensor(X),
                             paddle.to_tensor(Y)).numpy())
                  for _ in range(STEPS)]


def _single_controller_state_bytes(state):
    """Per-rank state bytes of the port's single-controller ZeRO over two
    co-located ranks, for the same MLP and AdamW."""
    net = tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.Tanh(),
                         tnn.Linear(16, 4, device="cpu"))
    tweights.from_paddle_tpu_state(state, net)
    o = topt.AdamW(ADAM_LR, parameters=net.parameters())
    mesh = tdist.ProcessMesh([0, 1], ["dp"], devices="cpu")
    tdist.shard_optimizer(o, tdist.ShardingStage1("dp", mesh))
    return o._zero.state_bytes()["per_rank"]


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_across_processes_matches_one_process(world2, mlp_case,
                                                   jax_adamw_serial, stage):
    """ZeRO stage 1 / 2 / 3 under DataParallel across two processes: the
    3 AdamW losses against the JAX package's serial run over the whole
    batch (rtol 1e-5), each rank holding exactly the per-rank state
    bytes of the port's single-controller ZeRO (half of every sharded
    moment), stages 2 and 3 freeing the whole gradients."""
    state = mlp_case[0]
    jstate, want = jax_adamw_serial
    for k, v in state.items():          # the same initial weights
        np.testing.assert_array_equal(jstate[k], v)
    per_rank = _single_controller_state_bytes(state)
    for r, (res, _) in enumerate(world2):
        got = res[f"zero{stage}"]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5,
                                   atol=1e-6)
        assert got["state_bytes"]["local"] == per_rank[r]
        assert got["state_bytes"]["replicated"] == 0
        assert got["grads_freed"] == (stage >= 2)


@pytest.mark.parametrize("name", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [True, False])
def test_context_parallel_across_processes(world2, attn_inputs, name,
                                           causal):
    """Ring (isend / irecv round the ring, dk / dv travelling back) and
    Ulysses (alltoall_single) across two processes against the JAX
    package's ring / Ulysses on a 2-device CPU mesh, on the same inputs:
    each rank's shard of the output and of ``jax.grad`` of
    sum(out * w) (1e-5)."""
    jfn = {"ring": jring.ring_flash_attention,
           "ulysses": jring.ulysses_attention}[name]
    axis = {"ring": "sp", "ulysses": "sep"}[name]
    jmesh = Mesh(np.array(jax.devices()[:2]), (axis,))
    w = jnp.asarray(attn_inputs["w"])

    def loss(q, k, v):
        out = jfn(q, k, v, jmesh, axis, causal=causal)
        return jnp.sum(out * w), out
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(attn_inputs[x]) for x in "qkv"))
    out, grads = np.asarray(out), [np.asarray(g) for g in grads]
    tag = f"{name}_{int(causal)}"
    sl = RING["s"] // 2
    for r in range(2):
        arr = world2[r][1]
        sl_r = slice(r * sl, (r + 1) * sl)
        np.testing.assert_allclose(arr[tag + "_out"], out[:, sl_r],
                                   rtol=1e-5, atol=1e-5)
        for x, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(arr[f"{tag}_{x}"], g[:, sl_r],
                                       rtol=1e-5, atol=1e-5)


def _serial_dp_mp():
    """tests/test_multihost_hybrid.py:132-154's serial reference."""
    rng = np.random.default_rng(11)
    W1 = (rng.standard_normal((8, 16)) * 0.2).astype("float32")
    W2 = (rng.standard_normal((16, 4)) * 0.2).astype("float32")
    X = rng.standard_normal((8, 8)).astype("float32")
    Y = rng.standard_normal((8, 4)).astype("float32")
    inputs = dict(W1=W1.copy(), W2=W2.copy(), X=X, Y=Y)
    serial = []
    for _ in range(4):
        H = np.maximum(X @ W1, 0.0)
        P_ = H @ W2
        serial.append(float(np.mean((P_ - Y) ** 2)))
        gP = 2.0 * (P_ - Y) / P_.size
        gW2 = H.T @ gP
        gH = gP @ W2.T
        gH[H <= 0] = 0.0
        gW1 = X.T @ gH
        W1 -= 0.1 * gW1
        W2 -= 0.1 * gW2
    return inputs, serial


def test_four_process_dp_mp_matches_serial(tmp_path_factory):
    """dp 2 x mp 2 across four processes: a column-parallel then a
    row-parallel linear over the mp subgroups (new_group), the batch and
    the gradient sums over the dp subgroups; 4 SGD losses against the
    serial run of tests/test_multihost_hybrid.py (rtol 1e-4)."""
    tmp = tmp_path_factory.mktemp("world4")
    inputs, serial = _serial_dp_mp()
    np.savez(tmp / "inputs4.npz", **inputs)
    out = _launch(tmp, WORKER4, 4)
    for res, _ in out:
        assert res["shapes"] == [[8, 8], [4, 8]]
        np.testing.assert_allclose(res["losses"], serial, rtol=1e-4,
                                   atol=1e-6)
