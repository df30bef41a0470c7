"""The port's flashmask attention and dense (masked, dropout) attention
against the JAX package on the CPU.

``F.flashmask_attention`` (through ``FlashmaskAttention``: on the CPU the
plain versions of the masked flash forward and backward) is held against
``flashmask_attention_fwd(..., interpret=True, block_q=16, block_k=16)``,
which runs the Pallas forward and, under ``jax.vjp``, the Pallas dq and
dk/dv kernels with the range-mask operands: every bound form (causal 1 or
2 bounds, bidirectional 2 or 4), bound head dims 1, H_kv and H under GQA,
and rows that see no key. ``window_size`` with S != T, the lse and
``return_seed_offset`` are held against the JAX ``F.flashmask_attention``.
``scaled_dot_product_attention`` with a bool or additive mask, and its
gradients, against ``_sdpa_xla``; dropout by statistics.

Tolerances (float32): outputs rtol 2e-4 / atol 2e-5 (the tolerance of the
JAX package's own flashmask tests: two blockings of the online softmax),
lse the same on rows that see a key (the JAX dense path gives a row that
sees nothing the logsumexp of its -1e30 logits, the kernels -1e30), and
gradients within 1e-4 of each tensor's largest value.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn.functional.attention import (_flashmask_intervals,
                                                _sdpa_xla)
from paddle_tpu.ops.pallas.flash_attention import flashmask_attention_fwd

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
B, S, H, HKV, D = 2, 32, 4, 2, 16


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _indices(rng, kh, causal, nb, s=S):
    """startend_row_indices [B, kh, S, nb] of each form, the masked rows
    below (LT) and above (UT) the diagonal, as the reference documents
    them."""
    col = np.arange(s, dtype=np.int32)
    shape = (B, kh, s)
    if causal:
        start = np.maximum(rng.integers(1, s + 1, shape), col + 1)
        if nb == 1:
            return start[..., None].astype(np.int32)
        end = np.minimum(start + rng.integers(0, s, shape), s)
        return np.stack([start, end], -1).astype(np.int32)
    lt_start = np.maximum(rng.integers(1, s + 1, shape), col + 1)
    ut_end = np.minimum(rng.integers(0, s, shape), col)
    if nb == 2:
        return np.stack([lt_start, ut_end], -1).astype(np.int32)
    lt_end = np.minimum(lt_start + rng.integers(0, s // 2, shape), s)
    ut_start = np.maximum(ut_end - rng.integers(0, s // 2, shape), 0)
    return np.stack([lt_start, lt_end, ut_start, ut_end],
                    -1).astype(np.int32)


def _blind_rows(idx):
    """4-bound indices whose first interval is rows [5, 7) for every key:
    rows 5 and 6 see no key, and every other row r still sees key r (the
    second interval of key t ends at or before t)."""
    idx = idx.copy()
    idx[..., 0], idx[..., 1] = 5, 7
    return idx


# (causal, bounds, bound heads): every form, with head dims 1, H_kv, H
CASES = [(True, 1, H), (True, 2, HKV), (True, 1, 1), (False, 2, 1),
         (False, 4, H), (False, 4, HKV), ("blind", 4, H)]


@pytest.mark.parametrize("causal,nb,kh", CASES,
                         ids=[f"{c}-{n}b-kh{k}" for c, n, k in CASES])
def test_flashmask_matches_pallas_kernels(causal, nb, kh):
    rng = np.random.default_rng(CASES.index((causal, nb, kh)))
    blind = causal == "blind"
    causal = False if blind else causal
    q, w = _f32(rng, (B, S, H, D)), _f32(rng, (B, S, H, D))
    k, v = _f32(rng, (B, S, HKV, D)), _f32(rng, (B, S, HKV, D))
    idx = _indices(rng, kh, causal, nb)
    if blind:
        idx = _blind_rows(idx)

    bounds = _flashmask_intervals(jnp.asarray(idx), causal, S)

    def f(q_, k_, v_):
        return flashmask_attention_fwd(q_, k_, v_, *bounds, causal=causal,
                                       interpret=True, block_q=16,
                                       block_k=16, return_lse=True)

    (ref, ref_lse), vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = vjp((jnp.asarray(w), jnp.zeros_like(ref_lse)))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = F.flashmask_attention(tq, tk, tv, torch.from_numpy(idx),
                                     causal=causal, return_softmax_lse=True)
    assert out.shape == (B, S, H, D) and lse.shape == (B, H, S)
    assert lse.dtype == torch.float32 and not lse.requires_grad
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    seen = (np.asarray(ref_lse) > -1e20) & (lse.numpy() > -1e20)
    np.testing.assert_allclose(lse.numpy()[seen], np.asarray(ref_lse)[seen],
                               rtol=RTOL, atol=ATOL)
    if blind:
        assert not seen[:, :, 5:7].any() and seen[:, :, 7:].all()
        assert float(out.detach()[:, 5:7].abs().max()) == 0.0
        assert bool((lse[:, :, 5:7] <= -1e29).all())
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref_g in zip((tq.grad, tk.grad, tv.grad), want):
        ref_g = np.asarray(ref_g)
        assert got.shape == ref_g.shape
        np.testing.assert_allclose(got.numpy(), ref_g,
                                   atol=1e-4 * max(1.0, np.abs(ref_g).max()))


@pytest.mark.parametrize("causal,window", [(True, 5), (False, (3, 4))],
                         ids=["causal", "bidirectional"])
def test_window_size_with_fewer_queries_matches_jax(causal, window):
    """window_size lowers to bounds with the (T - S) bottom-right offset;
    S = 24 queries over T = 40 keys."""
    rng = np.random.default_rng(11)
    s, t = 24, 40
    q = _f32(rng, (1, s, H, D))
    k, v = _f32(rng, (1, t, HKV, D)), _f32(rng, (1, t, HKV, D))
    want, want_lse = JF.flashmask_attention(
        *map(paddle.to_tensor, (q, k, v)), causal=causal,
        window_size=window, return_softmax_lse=True)
    out, lse = F.flashmask_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal, window_size=window,
                                     return_softmax_lse=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    seen = lse.numpy() > -1e20
    np.testing.assert_allclose(lse.numpy()[seen], want_lse.numpy()[seen],
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="exclusive"):
        F.flashmask_attention(*map(torch.from_numpy, (q, k, v)),
                              startend_row_indices=torch.zeros(
                                  1, 1, t, 1, dtype=torch.int32),
                              window_size=window)


def test_return_structure_and_dense_paths_match_jax():
    """return_seed_offset gives int64 zeros [2]; without bounds (and with
    bounds under dropout) the dense path runs, as in JAX; a bound head
    dim that is not 1, H_kv or H is refused."""
    rng = np.random.default_rng(13)
    q = _f32(rng, (B, S, H, D))
    k, v = _f32(rng, (B, S, HKV, D)), _f32(rng, (B, S, HKV, D))
    idx = _indices(rng, H, True, 1)
    tq, tk, tv, ti = map(torch.from_numpy, (q, k, v, idx))
    out, lse, seed = F.flashmask_attention(
        tq, tk, tv, ti, causal=True, return_softmax_lse=True,
        return_seed_offset=True)
    assert seed.dtype == torch.int64 and seed.tolist() == [0, 0]
    out2, seed2 = F.flashmask_attention(tq, tk, tv, ti, causal=True,
                                        return_seed_offset=True)
    assert torch.equal(out, out2)
    jo = JF.flashmask_attention(*map(paddle.to_tensor, (q, k, v)),
                                startend_row_indices=paddle.to_tensor(idx),
                                causal=True)
    np.testing.assert_allclose(out.numpy(), jo.numpy(), rtol=RTOL, atol=ATOL)
    # no bounds: the dense path, causal, with lse from the logits
    d_out, d_lse = F.flashmask_attention(tq, tk, tv, causal=True,
                                         return_softmax_lse=True)
    j_out, j_lse = JF.flashmask_attention(*map(paddle.to_tensor, (q, k, v)),
                                          causal=True,
                                          return_softmax_lse=True)
    np.testing.assert_allclose(d_out.numpy(), j_out.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(d_lse.numpy(), j_lse.numpy(), rtol=RTOL,
                               atol=ATOL)
    # dropout while training takes the dense path: with p -> 0 of effect
    # (eval), it equals the kernel path
    e_out = F.flashmask_attention(tq, tk, tv, ti, causal=True, dropout=0.5,
                                  training=False)
    assert torch.equal(e_out, out)
    gen = torch.Generator().manual_seed(3)
    dr = F.flashmask_attention(tq, tk, tv, ti, causal=True, dropout=0.5,
                               generator=gen)
    assert dr.shape == out.shape and bool(torch.isfinite(dr).all())
    assert not torch.allclose(dr, out)
    with pytest.raises(ValueError, match="head dim"):
        F.flashmask_attention(tq, tk, tv, ti[:, :3], causal=True)


def test_flashmask_wrappers_on_cpu_and_refusals():
    """The wrappers take the plain versions on the CPU with no launch
    counted (masked or not); a meta tensor is refused, never computed
    plainly."""
    K.reset_launch_counts()
    rng = np.random.default_rng(9)
    q, k, v, w = (torch.from_numpy(_f32(rng, (1, 12, 2, 8)))
                  for _ in range(4))
    st = torch.from_numpy(np.full((1, 2, 12), 6, np.int32))
    en = torch.full_like(st, 12)
    out, lse = K.flashmask_attention_fwd(q, k, v, st, en, causal=True)
    want = K.flashmask_attention_bwd(q, k, v, out, lse, w, st, en,
                                     causal=True)
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    o, _ = K.FlashmaskAttention.apply(qq, kk, vv, st, en, None, None, True,
                                      None)
    (o * w).sum().backward()
    for g, r in zip((qq.grad, kk.grad, vv.grad), want):
        assert torch.equal(g, r)
    m = [x.to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError, match="meta"):
        K.flashmask_attention_fwd(*m, st.to("meta"), en.to("meta"))
    with pytest.raises(ValueError, match="meta"):
        K.flashmask_attention_bwd(*m, m[0], lse.to("meta"), m[0],
                                  st.to("meta"), en.to("meta"))


MASKS = ["bool_b1", "additive_bh", "bool_causal"]


@pytest.mark.parametrize("kind", MASKS)
def test_masked_sdpa_and_grads_match_sdpa_xla(kind):
    """A bool mask broadcast over heads (a padded batch), an additive
    per-head mask, and a mask together with the causal flag, under GQA:
    output, lse and gradients against _sdpa_xla."""
    rng = np.random.default_rng(MASKS.index(kind))
    s, t = 12, 16
    q, w = _f32(rng, (B, s, H, D)), _f32(rng, (B, s, H, D))
    k, v = _f32(rng, (B, t, HKV, D)), _f32(rng, (B, t, HKV, D))
    causal = kind == "bool_causal"
    if kind == "additive_bh":
        mask = _f32(rng, (B, H, s, t))
    else:
        lens = np.array([t, t - 5])
        mask = (np.arange(t)[None, None, None, :] <
                lens[:, None, None, None]).repeat(s, axis=2)
    jmask = jnp.asarray(mask)

    def f(q_, k_, v_):
        return _sdpa_xla(q_, k_, v_, jmask, causal=causal)

    ref, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(w))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(tq, tk, tv,
                                         attn_mask=torch.from_numpy(mask),
                                         is_causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref_g in zip((tq.grad, tk.grad, tv.grad), want):
        ref_g = np.asarray(ref_g)
        np.testing.assert_allclose(got.numpy(), ref_g,
                                   atol=1e-4 * max(1.0, np.abs(ref_g).max()))
    _, lse = F._sdpa_dense(*map(torch.from_numpy, (q, k, v)),
                           torch.from_numpy(mask), causal=causal,
                           return_lse=True)
    _, ref_lse = _sdpa_xla(*map(jnp.asarray, (q, k, v)), jmask,
                           causal=causal, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=RTOL,
                               atol=ATOL)
