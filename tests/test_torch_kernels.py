"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain PyTorch version in ``paddle_tpu_torch.ops.kernels`` (the path a
CPU tensor takes through the kernel wrappers) gets the same numpy inputs as
the Pallas kernel, run in interpret mode as the JAX package's own tests run
it: ``rms_norm_pallas(x, w, eps, True)``, ``swiglu_pallas(g, u, True)``,
``fused_rope_pallas(x, cos, sin, True)``,
``paged_decode_attention(..., interpret=True)``,
``ragged_paged_attention(..., interpret=True)``, their int8 twins
``paged_decode_attention_int8(..., interpret=True)`` and
``ragged_paged_attention_int8(..., interpret=True)`` (also against the
``*_xla`` references, live slots only: the reference averages an idle
slot, the kernels give it 0), and the flash forward both
as the TPU kernel ``_flash_fwd_bhsd(..., interpret=True)`` and as the
Pallas-on-GPU lowering ``_flash_fwd_gpu(..., interpret=True)``, with
blocks of 8. The int8 cases take random codes in [-127, 127] with random
per-page scales. The paged cases cover MHA and GQA, contexts ending mid-page
and on a page boundary, block-table entries past the context that point at
real (garbage) pages, decode, prefill-at-tail, padded and dummy ragged
rows, and an idle decode slot; the flash cases causal and not, MHA and
GQA, S_q = S_k, S_q < S_k (bottom-right causal alignment), S_q > S_k
(rows that see no key: 0 out, lse -1e30) and lengths that are no multiple
of the block.

The backward: ``flash_attention_bwd_plain`` against ``jax.grad`` through
``flash_attention_fwd(..., interpret=True)``, which runs the Pallas dq and
dk/dv kernels in interpret mode (as ``test_pallas_kernels.py`` does), and
with S_q < S_k against ``jax.vjp`` of ``_sdpa_reference_gqa``; the
autograd functions of RMSNorm, SwiGLU and RoPE against ``jax.vjp`` of
``_rms_xla``, ``_swiglu_bwd`` and ``_rope_bwd``. Gradient tolerance
float32: ATOL/RTOL as above (the attention gradients reach magnitudes of
~5 and the Pallas backward sums them over blocks of 8: ~1e-6 apart);
bfloat16 elementwise gradients within
one bf16 ulp of JAX's (the same float32 values rounded once, the last bits
summed in another order) and RoPE's exactly (the same bf16 operations).

Tolerance: float32, atol 2e-5 / rtol 1e-5 — the two sides sum the same
float32 products in different orders (einsum vs. online softmax over
pages), which moves the last few bits of values of order 1.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import jax

from paddle_tpu.ops.pallas.decode_attention import paged_decode_attention
from paddle_tpu.ops.pallas.flash_attention import (_flash_fwd_bhsd,
                                                   _sdpa_reference_gqa,
                                                   flash_attention_fwd)
from paddle_tpu.ops.pallas.fused_ffn import _swiglu_bwd, swiglu_pallas
from paddle_tpu.ops.pallas.norms import (_rms_xla, _rope_bwd,
                                         fused_rope_pallas, rms_norm_pallas)
from paddle_tpu.ops.pallas import quantized_attention as jqa
from paddle_tpu.ops.pallas.ragged_attention import ragged_paged_attention
from paddle_tpu.ops.primitive.lowering_gpu import _flash_fwd_gpu

from paddle_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def _pools(rng, n_pages, page, h_kv, d):
    return _f32(rng, (n_pages, page, h_kv, d)), _f32(rng, (n_pages, page,
                                                            h_kv, d))


# widths of the CUDA kernel's paths: 333 the scalar one, 2048 (training) and
# 4096 (Llama-2-7B) the vector one
@pytest.mark.parametrize("shape", [(6, 40), (2, 3, 64), (5, 333), (3, 2048),
                                   (2, 4096)])
def test_rms_norm_plain_matches_pallas(shape):
    rng = np.random.default_rng(0)
    x = _f32(rng, shape)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    ref = rms_norm_pallas(jnp.asarray(x), jnp.asarray(w), 1e-6, True)
    _close(K.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6), ref)


@pytest.mark.parametrize("shape", [(6, 48), (2, 3, 40)])
def test_swiglu_plain_matches_pallas(shape):
    rng = np.random.default_rng(1)
    g, u = _f32(rng, shape), _f32(rng, shape)
    ref = swiglu_pallas(jnp.asarray(g), jnp.asarray(u), True)
    _close(K.swiglu(torch.from_numpy(g), torch.from_numpy(u)), ref)


# decode: (context length, pages listed in the table) per sequence; the
# table lists real pages past the context, which masking must ignore
DECODE_CASES = {
    "mid_page": [(9, 4), (3, 2), (14, 4)],
    "page_aligned": [(8, 3), (16, 4), (4, 4)],
    "idle_slot": [(0, 2), (11, 3), (1, 1)],
}


@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_paged_decode_plain_matches_pallas(case, h_kv):
    rng = np.random.default_rng(2)
    h, d, page, p_max, n_pages = 4, 16, 4, 5, 16
    rows = DECODE_CASES[case]
    kp, vp = _pools(rng, n_pages, page, h_kv, d)
    bt = np.zeros((len(rows), p_max), np.int32)
    for i, (_, n_listed) in enumerate(rows):
        bt[i, :n_listed] = rng.choice(np.arange(1, n_pages), n_listed,
                                      replace=False)
    ctx = np.array([c for c, _ in rows], np.int32)
    q = _f32(rng, (len(rows), h, d))
    ref = paged_decode_attention(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(bt),
                                 jnp.asarray(ctx), interpret=True)
    port = K.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(ctx))
    _close(port, ref)


# ragged rows: (context length, q_len, pages listed, dummy)
RAGGED_CASES = {
    # a chunk at the tail of a cached prefix, ending mid-page; a decode
    # row; a first chunk shorter than Q_max (padded query rows); a dummy
    "mixed": [(13, 8, 5, False), (10, 1, 3, False), (3, 3, 2, False),
              (1, 1, 0, True)],
    # every row a full Q_max chunk, one ending on a page boundary
    "prefill": [(8, 8, 3, False), (16, 8, 5, False), (11, 8, 3, False),
                (9, 8, 4, False)],
    # all decode rows (q_len 1), contexts of different lengths
    "decode_rows": [(1, 1, 1, False), (17, 1, 5, False), (6, 1, 2, False),
                    (1, 1, 0, True)],
}


@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ragged_plain_matches_pallas(case, h_kv):
    rng = np.random.default_rng(3)
    h, d, page, p_max, n_pages, q_max = 4, 16, 4, 5, 24, 8
    rows = RAGGED_CASES[case]
    kp, vp = _pools(rng, n_pages, page, h_kv, d)
    bt = np.zeros((len(rows), p_max), np.int32)   # dummy rows: trash page
    for i, (_, _, n_listed, _) in enumerate(rows):
        bt[i, :n_listed] = rng.choice(np.arange(1, n_pages), n_listed,
                                      replace=False)
    ctx = np.array([r[0] for r in rows], np.int32)
    ql = np.array([r[1] for r in rows], np.int32)
    q = _f32(rng, (len(rows), q_max, h, d))
    ref = ragged_paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(bt),
                                 jnp.asarray(ctx), jnp.asarray(ql),
                                 interpret=True)
    port = K.ragged_paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(ctx), torch.from_numpy(ql))
    _close(port, ref)
    for i, (_, n, _, _) in enumerate(rows):      # padded query rows are 0
        assert float(port[i, n:].abs().sum()) == 0.0


def _int8_pools(rng, n_pages, page, h_kv, d):
    codes = [rng.integers(-127, 128, (n_pages, page, h_kv, d)).astype(np.int8)
             for _ in range(2)]
    scales = [(0.1 + 3 * rng.random(n_pages)).astype(np.float32)
              for _ in range(2)]
    return codes, scales


def _table(rng, listed, n_pages, p_max):
    bt = np.zeros((len(listed), p_max), np.int32)   # dummy rows: trash page
    for i, n in enumerate(listed):
        bt[i, :n] = rng.choice(np.arange(1, n_pages), n, replace=False)
    return bt


@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_paged_decode_int8_plain_matches_pallas(case, h_kv):
    rng = np.random.default_rng(6)
    h, d, page, p_max, n_pages = 4, 16, 4, 5, 16
    rows = DECODE_CASES[case]
    (kc, vc), (ks, vs) = _int8_pools(rng, n_pages, page, h_kv, d)
    bt = _table(rng, [n for _, n in rows], n_pages, p_max)
    ctx = np.array([c for c, _ in rows], np.int32)
    q = _f32(rng, (len(rows), h, d))
    args = [q, kc, vc, ks, vs, bt, ctx]
    scale = 1.0 / float(np.sqrt(d))        # a python float: weakly typed
    ref = jqa.paged_decode_attention_int8(*map(jnp.asarray, args),
                                          scale=scale, interpret=True)
    xla = jqa.paged_decode_attention_int8_xla(*map(jnp.asarray, args))
    port = K.paged_decode_attention_int8(*map(torch.from_numpy, args))
    assert port.dtype == torch.float32
    _close(port, ref)
    live = ctx > 0
    _close(port[torch.from_numpy(live)], np.asarray(xla)[live])
    assert float(port[torch.from_numpy(~live)].abs().sum()) == 0.0


@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ragged_int8_plain_matches_pallas(case, h_kv):
    rng = np.random.default_rng(7)
    h, d, page, p_max, n_pages, q_max = 4, 16, 4, 5, 24, 8
    rows = RAGGED_CASES[case]
    (kc, vc), (ks, vs) = _int8_pools(rng, n_pages, page, h_kv, d)
    bt = _table(rng, [r[2] for r in rows], n_pages, p_max)
    ctx = np.array([r[0] for r in rows], np.int32)
    ql = np.array([r[1] for r in rows], np.int32)
    q = _f32(rng, (len(rows), q_max, h, d))
    args = [q, kc, vc, ks, vs, bt, ctx, ql]
    scale = 1.0 / float(np.sqrt(d))
    ref = jqa.ragged_paged_attention_int8(*map(jnp.asarray, args),
                                          scale=scale, interpret=True)
    xla = jqa.ragged_paged_attention_int8_xla(*map(jnp.asarray, args))
    port = K.ragged_paged_attention_int8(*map(torch.from_numpy, args))
    _close(port, ref)
    _close(port, xla)
    for i, (_, n, _, _) in enumerate(rows):      # padded query rows are 0
        assert float(port[i, n:].abs().sum()) == 0.0


def test_int8_wrappers_refuse_float_pools_and_bad_scales():
    """The int8 wrappers take int8 codes and one float32 scale per page;
    anything else raises on the CPU as on the card (never a cast, never a
    fallback). A CPU call counts no launch; a meta tensor is refused."""
    rng = np.random.default_rng(8)
    (kc, vc), (ks, vs) = _int8_pools(rng, 6, 4, 2, 8)
    kc, vc, ks, vs = map(torch.from_numpy, (kc, vc, ks, vs))
    q = torch.ones(2, 4, 8)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    ctx = torch.tensor([5, 0], dtype=torch.int32)
    K.reset_launch_counts()
    assert K.paged_decode_attention_int8(q, kc, vc, ks, vs, bt,
                                         ctx).shape == q.shape
    q4 = torch.ones(2, 3, 4, 8)
    ql = torch.tensor([3, 1], dtype=torch.int32)
    assert K.ragged_paged_attention_int8(q4, kc, vc, ks, vs, bt, ctx,
                                         ql).shape == q4.shape
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)
    with pytest.raises(TypeError, match="int8"):
        K.paged_decode_attention_int8(q, kc.float(), vc.float(), ks, vs, bt,
                                      ctx)
    with pytest.raises(TypeError, match="float32"):
        K.paged_decode_attention_int8(q, kc, vc, ks.double(), vs, bt, ctx)
    with pytest.raises(TypeError, match="one row"):
        K.ragged_paged_attention_int8(q4, kc, vc, ks[:3], vs, bt, ctx, ql)
    with pytest.raises(ValueError, match="rank"):
        K.ragged_paged_attention_int8(q, kc, vc, ks, vs, bt, ctx, ql)
    m = [t.to("meta") for t in (q, kc, vc, ks, vs, bt, ctx)]
    with pytest.raises(ValueError, match="meta"):
        K.paged_decode_attention_int8(*m)


@pytest.mark.parametrize("shape", [(2, 8, 4, 16), (1, 5, 3, 8)])
def test_fused_rope_plain_matches_pallas(shape):
    rng = np.random.default_rng(4)
    x = _f32(rng, shape)
    cos, sin = _f32(rng, shape[1::2]), _f32(rng, shape[1::2])   # [S, D]
    ref = fused_rope_pallas(jnp.asarray(x), jnp.asarray(cos),
                            jnp.asarray(sin), True)
    _close(K.fused_rope(torch.from_numpy(x), torch.from_numpy(cos),
                        torch.from_numpy(sin)), ref)


def _bhsd(x):
    """[B, S, H, D] numpy -> the Pallas kernels' [B*H, S, D]."""
    b, s, h, d = x.shape
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                       .reshape(b * h, s, d))


# (S_q, S_k): equal, bottom-right causal with S_q < S_k, S_q > S_k (the
# first S_q - S_k rows see no key under the causal mask), and a length no
# multiple of the block of 8
FLASH_SHAPES = [(24, 24), (10, 30), (30, 10), (13, 13)]


@pytest.mark.parametrize("s_q,s_k", FLASH_SHAPES,
                         ids=[f"{a}x{b}" for a, b in FLASH_SHAPES])
@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_plain_matches_pallas(causal, h_kv, s_q, s_k):
    rng = np.random.default_rng(5)
    b, h, d = 2, 4, 16
    scale = 1.0 / float(np.sqrt(d))   # a python float: weakly typed
    q = _f32(rng, (b, s_q, h, d))
    k, v = _f32(rng, (b, s_k, h_kv, d)), _f32(rng, (b, s_k, h_kv, d))
    out, lse = K.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    assert out.shape == (b, s_q, h, d) and lse.shape == (b, h, s_q)
    assert lse.dtype == torch.float32

    ref, ref_lse = _flash_fwd_bhsd(_bhsd(q), _bhsd(k), _bhsd(v), causal,
                                   scale, h, h_kv, block_q=8, block_k=8,
                                   interpret=True)
    ref = np.asarray(ref).reshape(b, h, s_q, d).transpose(0, 2, 1, 3)
    ref_lse = np.asarray(ref_lse)[:, :s_q, 0].reshape(b, h, s_q)
    _close(out, ref)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL, rtol=RTOL)

    gpu = _flash_fwd_gpu(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale, h,
                         h_kv, 8, 8, True)
    _close(out, np.asarray(gpu).reshape(b, h, s_q, d).transpose(0, 2, 1, 3))

    blind = s_q - s_k if causal and s_q > s_k else 0   # rows with no key
    assert float(out[:, :blind].abs().sum()) == 0.0
    assert bool((lse[:, :, :blind] <= -1e29).all())
    assert bool(torch.isfinite(out).all())


def test_wrappers_take_the_plain_path_only_on_cpu():
    """A CPU tensor takes the plain version and bumps no launch counter;
    a tensor on any other device is refused, never computed plainly."""
    K.reset_launch_counts()
    x = torch.ones(2, 8)
    K.rms_norm(x, torch.ones(8))
    K.swiglu(x, x)
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)
    with pytest.raises(ValueError, match="meta"):
        K.swiglu(x.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="meta"):
        K.rms_norm(x.to("meta"), torch.ones(8, device="meta"))


def test_flash_and_rope_wrappers_refuse_tensors_off_the_cpu():
    """The two kernels of the dense prefill: plain on the CPU with no
    launch counted; a meta tensor is refused, never computed plainly."""
    K.reset_launch_counts()
    q = torch.ones(1, 4, 2, 8)
    cos = torch.ones(4, 8)
    K.flash_attention_fwd(q, q, q, causal=True)
    K.fused_rope(q, cos, cos)
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)
    m = q.to("meta")
    with pytest.raises(ValueError, match="meta"):
        K.flash_attention_fwd(m, m, m, causal=True)
    with pytest.raises(ValueError, match="meta"):
        K.fused_rope(m, cos.to("meta"), cos.to("meta"))


def _flash_grads_port(q, k, v, w, causal, scale):
    """(dq, dk, dv) of sum(attention(q, k, v) * w) through the port's
    plain forward and backward."""
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out, lse = K.flash_attention_fwd(*t, causal=causal, scale=scale)
    return K.flash_attention_bwd(*t, out, lse, torch.from_numpy(w),
                                 causal=causal, scale=scale)


@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_bwd_plain_matches_pallas(causal, h_kv):
    rng = np.random.default_rng(6)
    b, s, h, d = 1, 96, 4, 16
    scale = 1.0 / float(np.sqrt(d))        # a python float: x64 is on
    q, w = _f32(rng, (b, s, h, d)), _f32(rng, (b, s, h, d))
    k, v = _f32(rng, (b, s, h_kv, d)), _f32(rng, (b, s, h_kv, d))

    def loss(q_, k_, v_):
        return (flash_attention_fwd(q_, k_, v_, causal=causal, scale=scale,
                                    interpret=True, block_q=8, block_k=8)
                * jnp.asarray(w)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _flash_grads_port(q, k, v, w, causal, scale)
    for g, r in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=RTOL)


def test_flash_attention_bwd_plain_bottom_right_matches_reference():
    """S_q < S_k under the causal mask (bottom-right aligned) with GQA,
    against jax.vjp of the XLA reference in the kernels' [B*H, S, D]
    layout."""
    rng = np.random.default_rng(7)
    b, s_q, s_k, h, h_kv, d = 2, 10, 30, 4, 2, 16
    scale = 1.0 / float(np.sqrt(d))
    q, w = _f32(rng, (b, s_q, h, d)), _f32(rng, (b, s_q, h, d))
    k, v = _f32(rng, (b, s_k, h_kv, d)), _f32(rng, (b, s_k, h_kv, d))
    _, vjp = jax.vjp(lambda q_, k_, v_: _sdpa_reference_gqa(
        q_, k_, v_, True, scale, h, h_kv), _bhsd(q), _bhsd(k), _bhsd(v))
    want = vjp(_bhsd(w))
    got = _flash_grads_port(q, k, v, w, True, scale)
    for g, r in zip(got, want):
        g = g.numpy().transpose(0, 2, 1, 3).reshape(np.asarray(r).shape)
        np.testing.assert_allclose(g, np.asarray(r), atol=ATOL,
                                   rtol=RTOL)


def _ulp_close(port, ref):
    """Within one bf16 ulp of the reference, elementwise."""
    ref = np.asarray(ref).astype(np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(port.float().numpy() - ref) <= ulp)


def _grads(fn, *inputs, out_grad):
    """Gradients of sum(fn(*inputs) * out_grad) with respect to inputs."""
    ts = [torch.from_numpy(x).requires_grad_() for x in inputs]
    (fn(*ts) * torch.from_numpy(out_grad)).sum().backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_op_gradients_match_jax(dtype):
    """The autograd functions of RMSNorm, SwiGLU and RoPE: forward through
    the wrapper, backward in plain PyTorch, against the JAX package's
    backward formulas on the same inputs."""
    rng = np.random.default_rng(8)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    close = _close if dtype == "float32" else _ulp_close

    def pair(shape):
        x = _f32(rng, shape)
        return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)

    # RMSNorm: grads of x and w (vjp of _rms_xla)
    (jx, tx), (jw, tw), (jg, tg) = pair((3, 5, 40)), pair((40,)), \
        pair((3, 5, 40))
    _, vjp = jax.vjp(lambda a, b: _rms_xla(a, b, 1e-6), jx, jw)
    want = vjp(jg)
    tx.requires_grad_()
    tw.requires_grad_()
    K.RMSNorm.apply(tx, tw, 1e-6).backward(tg)
    for got, ref in zip((tx.grad, tw.grad), want):
        assert got.dtype == tdt
        close(got, ref)

    # SwiGLU: _swiglu_bwd's formula in float32, cast to the input types
    (jgt, tgt), (ju, tu), (jg, tg) = pair((6, 48)), pair((6, 48)), \
        pair((6, 48))
    want = _swiglu_bwd(None, (jgt, ju), jg)
    tgt.requires_grad_()
    tu.requires_grad_()
    K.SwiGLU.apply(tgt, tu).backward(tg)
    for got, ref in zip((tgt.grad, tu.grad), want):
        assert got.dtype == tdt
        close(got, ref)

    # RoPE: grad of x only, in x's type
    (jx, tx), (jg, tg) = pair((2, 8, 3, 16)), pair((2, 8, 3, 16))
    cos, sin = _f32(rng, (8, 16)), _f32(rng, (8, 16))
    want, dcos, dsin = _rope_bwd(None, (jx, jnp.asarray(cos),
                                        jnp.asarray(sin)), jg)
    assert dcos is None and dsin is None
    tx.requires_grad_()
    K.FusedRoPE.apply(tx, torch.from_numpy(cos),
                      torch.from_numpy(sin)).backward(tg)
    assert tx.grad.dtype == tdt
    if dtype == "float32":
        _close(tx.grad, want)
    else:
        np.testing.assert_array_equal(tx.grad.float().numpy(),
                                      np.asarray(want).astype(np.float32))


def test_flash_bwd_wrapper_and_autograd_on_cpu():
    """The backward wrapper takes the plain version on the CPU with no
    launch counted and refuses a meta tensor; FlashAttention's backward
    gives what the wrapper gives."""
    K.reset_launch_counts()
    rng = np.random.default_rng(9)
    q, k, v, w = (torch.from_numpy(_f32(rng, (1, 12, 2, 8)))
                  for _ in range(4))
    out, lse = K.flash_attention_fwd(q, k, v, causal=True)
    want = K.flash_attention_bwd(q, k, v, out, lse, w, causal=True)
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    (K.FlashAttention.apply(qq, kk, vv, True, None) * w).sum().backward()
    for g, r in zip((qq.grad, kk.grad, vv.grad), want):
        assert torch.equal(g, r)
    m = [x.to("meta") for x in (q, k, v, out, lse, w)]
    with pytest.raises(ValueError, match="meta"):
        K.flash_attention_bwd(*m, causal=True)
