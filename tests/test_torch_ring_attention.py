"""The port's ring and Ulysses context parallelism against
``paddle_tpu.ops.ring_attention`` on the 8-device CPU mesh
(``tests/conftest.py``): float32, causal and not, forward within 1e-5 and
gradients within 1e-5 of ``jax.grad`` of the JAX ring. Two routes run:
"kernel" is the port's functions (the flash wrappers, whose CPU form is
their plain version); "plain" is JAX's ``_block_attn`` / ``_merge``
arithmetic written in torch here (``_plain_ring``, ``_plain_ulysses``),
held against the JAX ring too and against the port's output."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from paddle_tpu.ops import ring_attention as jring

import paddle_tpu_torch as ptt
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.distributed import ProcessMesh
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops import ring_attention as tring

TOL = 1e-5
SHAPE = (2, 32, 4, 16)       # B, S, H, D: S splits over 4 ranks (8 keys each)
NEG_INF = -1e30


@pytest.fixture(autouse=True)
def _cpu():
    """The CPU as the current device; the previous one back after."""
    prev = tdevice._CURRENT[0]
    ptt.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype("float32") for _ in range(4)]


def _meshes(axis, n=4):
    return (Mesh(np.array(jax.devices()[:n]), (axis,)),
            ProcessMesh(list(range(n)), [axis], devices="cpu"))


CASES = [(name, causal, route) for name in ("ring", "ulysses")
         for causal in (True, False) for route in ("kernel", "plain")]


def _block_attn(q, k, v, scale, mask):
    """JAX's ``_block_attn``: q [B, H, sq, D], k/v [B, H, skv, D] ->
    (numerator, max, denominator)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    return o.float(), m, p.sum(dim=-1, keepdim=True)


def _merge(acc, o, m_acc, m, l_acc, l_):
    """JAX's ``_merge``."""
    m_new = torch.maximum(m_acc, m)
    alpha = torch.exp(m_acc - m_new)
    beta = torch.exp(m - m_new)
    return acc * alpha + o * beta, m_new, l_acc * alpha + l_ * beta


def _plain_ring(q, k, v, n, causal):
    """JAX's ring in torch over n sequence shards: each query shard
    visits the key shards in the ring's order, masked blocks included."""
    scale = 1.0 / q.shape[-1] ** 0.5
    qs, ks, vs = ([c.transpose(1, 2) for c in t.chunk(n, dim=1)]
                  for t in (q, k, v))
    b, h, sl, d = qs[0].shape
    outs = []
    for i in range(n):
        acc = torch.zeros((b, h, sl, d))
        m_acc = torch.full((b, h, sl, 1), NEG_INF)
        l_acc = torch.zeros((b, h, sl, 1))
        for j in [(i + t) % n for t in range(n)]:
            mask = None
            if causal:
                qpos = i * sl + torch.arange(sl)[:, None]
                kpos = j * sl + torch.arange(sl)[None, :]
                mask = (qpos >= kpos)[None, None]
            o, m, l_ = _block_attn(qs[i], ks[j], vs[j], scale, mask)
            acc, m_acc, l_acc = _merge(acc, o, m_acc, m, l_acc, l_)
        outs.append((acc / l_acc.clamp_min(1e-30)).transpose(1, 2))
    return torch.cat(outs, dim=1)


def _plain_ulysses(q, k, v, n, causal):
    """JAX's Ulysses in torch: full attention over the whole sequence
    for each rank's head group (the all-to-all moves no values)."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        sq = s.shape[-2]
        cm = torch.ones(sq, sq, dtype=torch.bool).tril()
        s = torch.where(cm, s, torch.full_like(s, NEG_INF))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def _run(name, route, causal, q, k, v):
    """The port's function (route "kernel") or the plain version."""
    if route == "plain":
        fn = _plain_ring if name == "ring" else _plain_ulysses
        return fn(q, k, v, 4, causal)
    _, tfn, axis = _fns(name)
    return tfn(q, k, v, _meshes(axis)[1], axis, causal=causal)


def _fns(name):
    if name == "ring":
        return jring.ring_flash_attention, tring.ring_flash_attention, "sp"
    return jring.ulysses_attention, tring.ulysses_attention, "sep"


@functools.lru_cache(maxsize=None)
def _jax_ref(name, causal):
    """The JAX function's output and its gradients (one compile each)."""
    jfn, _, axis = _fns(name)
    jmesh, _ = _meshes(axis)
    q, k, v, w = _inputs(1)

    def loss(q_, k_, v_):
        out = jfn(q_, k_, v_, jmesh, axis, causal=causal)
        return jnp.sum(out * jnp.asarray(w)), out
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name,causal,route", CASES)
def test_forward_matches_jax(name, causal, route):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1))
    got = _run(name, route, causal, q, k, v)
    np.testing.assert_allclose(got.numpy(), _jax_ref(name, causal)[0],
                               rtol=TOL, atol=TOL)
    if route == "plain":        # the port's output against the plain one
        np.testing.assert_allclose(
            _run(name, "kernel", causal, q, k, v).numpy(), got.numpy(),
            rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,causal,route", CASES)
def test_gradients_match_jax_grad(name, causal, route):
    q, k, v, w = _inputs(1)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = _run(name, route, causal, *ts)
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, _jax_ref(name, causal)[1]):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=TOL, atol=TOL)


def test_ring_of_eight_and_shard_lists():
    """The 8-rank ring, and a list of shards in gives a list out, equal to
    the whole tensor's split."""
    jmesh, tmesh = _meshes("sp", 8)
    q, k, v, _ = _inputs(2)
    want = np.asarray(jring.ring_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmesh, "sp"))
    whole = tring.ring_flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), tmesh, "sp")
    np.testing.assert_allclose(whole.numpy(), want, rtol=TOL, atol=TOL)
    parts = tring.ring_flash_attention(
        *([torch.from_numpy(c.copy()) for c in np.split(x, 8, axis=1)]
          for x in (q, k, v)), tmesh, "sp")
    assert isinstance(parts, list) and len(parts) == 8
    np.testing.assert_array_equal(torch.cat(parts, dim=1).numpy(),
                                  whole.numpy())


def test_kernel_route_visits_only_visible_blocks(monkeypatch):
    """At 4 ranks the causal ring runs 10 of the 16 blocks (the masked
    ones contribute exactly nothing in the JAX arithmetic), the diagonal
    ones causal; the backward runs the same 10 through the flash
    backward; non-causal runs all 16 unmasked."""
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = K.flash_attention_fwd, K.flash_attention_bwd

    def spy_fwd(q, k, v, causal=False, scale=None):
        calls["fwd"].append(causal)
        return fwd(q, k, v, causal, scale)

    def spy_bwd(q, k, v, out, lse, dout, causal=False, scale=None):
        calls["bwd"].append(causal)
        return bwd(q, k, v, out, lse, dout, causal, scale)
    monkeypatch.setattr(K, "flash_attention_fwd", spy_fwd)
    monkeypatch.setattr(K, "flash_attention_bwd", spy_bwd)
    _, tmesh = _meshes("sp")
    q, k, v, _ = _inputs(3)
    for causal, n_blocks, n_diag in ((True, 10, 4), (False, 16, 0)):
        calls["fwd"].clear()
        calls["bwd"].clear()
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        tring.ring_flash_attention(*ts, tmesh, "sp", causal=causal) \
            .sum().backward()
        assert len(calls["fwd"]) == len(calls["bwd"]) == n_blocks
        assert sum(calls["fwd"]) == sum(calls["bwd"]) == n_diag


def test_refusals():
    _, tmesh = _meshes("sp")
    q = torch.zeros(1, 30, 4, 16)
    with pytest.raises(ValueError, match="does not split"):
        tring.ring_flash_attention(q, q, q, tmesh, "sp")
    with pytest.raises(ValueError, match="3 shards for a 4-rank axis"):
        tring.ring_flash_attention([q] * 3, [q] * 3, [q] * 3, tmesh, "sp")
    _, umesh = _meshes("sep")
    with pytest.raises(ValueError, match="heads"):
        tring.ulysses_attention(torch.zeros(1, 32, 6, 16),
                                torch.zeros(1, 32, 6, 16),
                                torch.zeros(1, 32, 6, 16), umesh, "sep")
