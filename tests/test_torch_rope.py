"""The port's RoPE forms against the JAX package's.

The RoPE wrappers (``paddle_tpu_torch.ops.kernels.rope``) take the plain
versions for CPU tensors, as here; on the card one launch of
``csrc/rope.cu`` computes each form, held against these same plain
versions by ``chip_smoke.py``. Checked on numpy inputs made from a seed:

- ``fused_rope_rows_plain`` (and ``fused_rope_qk`` with per-token rows)
  against ``paddle_tpu.models.llama._rope_rows``, for a decode step's
  ``[B, D]`` rows and a ragged chunk's ``[B, Q, D]``, with GQA (k with
  fewer heads than q);
- ``fused_rope_qk`` with ``[S, D]`` tables against
  ``fused_rope_pallas(..., interpret=True)`` applied to q and to k;
- ``fused_rope_bwd`` (q alone and q + k) against ``_rope_bwd``, and the
  autograd function ``FusedRoPEQK`` against ``jax.vjp`` of the Pallas
  kernel;
- the wrappers' refusals (non-contiguous input, wrong tables, k's heads
  not dividing q's, meta tensors);
- ``incubate.nn.functional.fused_rotary_position_embedding`` against the
  JAX op;
- a tiny Llama's paged decode and ragged steps through one
  ``fused_rope_qk`` call a layer, giving the JAX engine's greedy tokens.

Tolerance: float32 within 1e-6 (absolute and relative), bfloat16 within
one bf16 ulp of the JAX result. Both sides compute the same operations in
x's type, but XLA on the CPU may keep excess precision between operations
(fusing a product into the sum), which moves a float32 result in its last
bits and a bf16 result by at most one rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JIF
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import _rope_rows
from paddle_tpu.ops.pallas.norms import _rope_bwd, fused_rope_pallas

from paddle_tpu_torch import weights
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.inference.engine import GenerationEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

TOL = 1e-6
DTYPES = ["float32", "bfloat16"]


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(x, dtype):
    """A numpy float32 array as (jax array, torch tensor) of `dtype`."""
    return jnp.asarray(x, jnp.dtype(dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _close(port, ref, dtype):
    ref = np.asarray(ref).astype(np.float32)
    got = port.float().numpy()
    assert port.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert np.all(np.abs(got - ref) <= ulp)


# (B, Q): a decode step's [B, D] rows (Q = 1) and a ragged chunk's
# [B, Q, D]; (Hq, Hk): MHA and GQA
ROWS = [(4, 1), (3, 5)]
HEADS = [(4, 4), (4, 2)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,hk", HEADS, ids=["mha", "gqa"])
@pytest.mark.parametrize("b,q", ROWS, ids=["decode", "chunk"])
def test_rows_match_jax_rope_rows(b, q, hq, hk, dtype):
    rng = np.random.default_rng(0)
    d = 16
    xq, xk = _f32(rng, (b, q, hq, d)), _f32(rng, (b, q, hk, d))
    shape = (b, d) if q == 1 else (b, q, d)
    cos, sin = _f32(rng, shape), _f32(rng, shape)
    (jq, tq), (jk, tk) = _pair(xq, dtype), _pair(xk, dtype)
    jc, js = jnp.asarray(cos), jnp.asarray(sin)
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    want_q, want_k = _rope_rows(jq, jc, js), _rope_rows(jk, jc, js)
    _close(K.fused_rope_rows_plain(tq, tc, ts), want_q, dtype)
    got_q, got_k = K.fused_rope_qk(tq, tk, tc, ts)
    _close(got_q, want_q, dtype)
    _close(got_k, want_k, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,hk", HEADS, ids=["mha", "gqa"])
@pytest.mark.parametrize("table_dtype", ["float32", "x"])
def test_qk_matches_pallas_on_q_and_k(hq, hk, dtype, table_dtype):
    """[S, D] tables, float32 or already in x's type (a model cast with
    .to(dtype) carries its tables in that type)."""
    rng = np.random.default_rng(1)
    b, s, d = 2, 8, 16
    xq, xk = _f32(rng, (b, s, hq, d)), _f32(rng, (b, s, hk, d))
    cos, sin = _f32(rng, (s, d)), _f32(rng, (s, d))
    (jq, tq), (jk, tk) = _pair(xq, dtype), _pair(xk, dtype)
    tdt = torch.float32 if table_dtype == "float32" else tq.dtype
    tc, ts = (torch.from_numpy(t).to(tdt) for t in (cos, sin))
    jc, js = (jnp.asarray(t.float().numpy()) for t in (tc, ts))
    got_q, got_k = K.fused_rope_qk(tq, tk, tc, ts)
    _close(got_q, fused_rope_pallas(jq, jc, js, True), dtype)
    _close(got_k, fused_rope_pallas(jk, jc, js, True), dtype)
    _close(K.fused_rope(tq, tc, ts), fused_rope_pallas(jq, jc, js, True),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bwd_matches_jax_rope_bwd(dtype):
    rng = np.random.default_rng(2)
    b, s, hq, hk, d = 2, 6, 4, 2, 16
    cos, sin = _f32(rng, (s, d)), _f32(rng, (s, d))
    jc, js = jnp.asarray(cos), jnp.asarray(sin)
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    (jx, _), (jg, tg) = _pair(_f32(rng, (b, s, hq, d)), dtype), \
        _pair(_f32(rng, (b, s, hq, d)), dtype)
    (jxk, _), (jgk, tgk) = _pair(_f32(rng, (b, s, hk, d)), dtype), \
        _pair(_f32(rng, (b, s, hk, d)), dtype)
    want = _rope_bwd(True, (jx, jc, js), jg)[0]
    want_k = _rope_bwd(True, (jxk, jc, js), jgk)[0]
    _close(K.fused_rope_bwd(tg, tc, ts), want, dtype)
    got, got_k = K.fused_rope_bwd(tg, tc, ts, tgk)
    _close(got, want, dtype)
    _close(got_k, want_k, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_qk_autograd_matches_jax_vjp(dtype):
    """FusedRoPEQK: q and k forward in one call, their gradients through
    fused_rope_bwd, against jax.vjp of the Pallas kernel."""
    rng = np.random.default_rng(3)
    b, s, hq, hk, d = 2, 5, 4, 2, 8
    cos, sin = _f32(rng, (s, d)), _f32(rng, (s, d))
    jc, js = jnp.asarray(cos), jnp.asarray(sin)
    (jq, tq), (jk, tk) = _pair(_f32(rng, (b, s, hq, d)), dtype), \
        _pair(_f32(rng, (b, s, hk, d)), dtype)
    (jgq, tgq), (jgk, tgk) = _pair(_f32(rng, (b, s, hq, d)), dtype), \
        _pair(_f32(rng, (b, s, hk, d)), dtype)
    tq.requires_grad_()
    tk.requires_grad_()
    oq, ok = F.fused_rope_qk(tq, tk, torch.from_numpy(cos),
                             torch.from_numpy(sin))
    torch.autograd.backward([oq, ok], [tgq, tgk])
    for x, jx, jg, grad in ((tq, jq, jgq, tq.grad), (tk, jk, jgk, tk.grad)):
        out, vjp = jax.vjp(lambda a: fused_rope_pallas(a, jc, js, True), jx)
        _close(grad, vjp(jg)[0], dtype)
    _close(oq.detach(), fused_rope_pallas(jq, jc, js, True), dtype)
    _close(ok.detach(), fused_rope_pallas(jk, jc, js, True), dtype)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    q = torch.ones(2, 4, 4, 8)
    k = torch.ones(2, 4, 2, 8)
    cos = torch.ones(4, 8)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_rope_qk(q.transpose(1, 2), k, cos, cos)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_rope(q, cos.t().contiguous().t(), cos)
    with pytest.raises(ValueError, match="do not fit"):
        K.fused_rope_qk(q, k, torch.ones(5, 8), torch.ones(5, 8))
    with pytest.raises(ValueError, match="do not fit"):
        K.fused_rope(q, torch.ones(2, 4, 8), torch.ones(2, 4, 8))
    with pytest.raises(ValueError, match="do not fit"):
        K.fused_rope_bwd(q, torch.ones(2, 4, 8), torch.ones(2, 4, 8))
    with pytest.raises(ValueError, match="one dtype"):
        K.fused_rope_qk(q, k, cos, cos.double())
    with pytest.raises(ValueError, match="one dtype"):
        K.fused_rope(q, cos, torch.ones(4, 6))
    with pytest.raises(ValueError, match="do not divide"):
        K.fused_rope_qk(q, torch.ones(2, 4, 3, 8), cos, cos)
    with pytest.raises(ValueError, match="do not divide"):
        K.fused_rope_bwd(q, cos, cos, torch.ones(2, 4, 3, 8))
    with pytest.raises(ValueError, match="x's type"):
        K.fused_rope_qk(q, k.double(), cos, cos)
    with pytest.raises(ValueError, match="even"):
        K.fused_rope(torch.ones(1, 4, 2, 7), torch.ones(4, 7),
                     torch.ones(4, 7))
    m = [t.to("meta") for t in (q, k, cos)]
    with pytest.raises(ValueError, match="meta"):
        K.fused_rope_qk(m[0], m[1], m[2], m[2])
    with pytest.raises(ValueError, match="meta"):
        K.fused_rope_bwd(m[0], m[2], m[2], m[0])


def test_cpu_calls_count_no_launch_and_parts_reset():
    K.reset_launch_counts()
    q = torch.ones(1, 3, 2, 8)
    cos = torch.ones(3, 8)
    K.fused_rope_qk(q, q, cos, cos)
    K.fused_rope_bwd(q, cos, cos, q)
    counts = K.launch_counts()
    assert {"fused_rope", "fused_rope_bwd", "fused_rope.qk",
            "fused_rope.scalar", "fused_rope_bwd.scalar"} <= set(counts)
    assert counts == dict.fromkeys(counts, 0)
    K.fused_rope_qk.launches = 3
    K.reset_launch_counts()
    assert K.launch_counts()["fused_rope.qk"] == 0


@pytest.mark.parametrize("k_given", [True, False], ids=["qk", "q"])
@pytest.mark.parametrize("form", ["sd", "1s1d"])
def test_fused_rotary_position_embedding_matches_jax(form, k_given):
    rng = np.random.default_rng(4)
    b, s, h, d = 2, 6, 4, 16
    q, k, v = (_f32(rng, (b, s, h, d)) for _ in range(3))
    cos, sin = _f32(rng, (s, d)), _f32(rng, (s, d))
    if form == "1s1d":
        cos, sin = cos[None, :, None], sin[None, :, None]
    kk = k if k_given else None
    want = JIF.fused_rotary_position_embedding(
        paddle.to_tensor(q), None if kk is None else paddle.to_tensor(kk),
        paddle.to_tensor(v), sin=paddle.to_tensor(sin),
        cos=paddle.to_tensor(cos))
    tv = torch.from_numpy(v)
    got = TIF.fused_rotary_position_embedding(
        torch.from_numpy(q), None if kk is None else torch.from_numpy(kk),
        tv, sin=torch.from_numpy(sin), cos=torch.from_numpy(cos),
        position_ids=torch.zeros(b, s, dtype=torch.int64),
        use_neox_rotary_style=False)
    # the JAX op wraps a missing k as a Tensor of None
    want = [getattr(w, "_value", w) for w in want]
    assert got[2] is tv
    assert (got[1] is None) == (want[1] is None) == (not k_given)
    for g, w in zip(got[:2], want[:2]):
        if w is not None:
            _close(g, w, "float32")


ENGINE_KW = dict(max_slots=2, page_size=4, max_seq_len=64, prefix_cache=True,
                 prefill_chunk=8, mixed_step=True)


def test_paged_steps_rotate_q_and_k_in_one_call_and_match_jax(monkeypatch):
    """Prompts longer than the chunk (ragged steps) and decode steps: one
    fused_rope_qk call a layer per model step, and the JAX engine's greedy
    tokens."""
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny())      # GQA: 4 q heads, 2 kv heads
    arrays = {n: np.asarray(p._value, np.float32)
              for n, p in jm.named_parameters()}
    cfg = LlamaConfig.tiny()
    tm = LlamaForCausalLM(cfg, device="cpu")
    weights.from_paddle_tpu_state(arrays, tm)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 128, n).astype(np.int32) for n in (13, 11, 9)]
    want = jm.generate_batch(prompts, max_new_tokens=6, **ENGINE_KW)

    calls = []
    real = F.fused_rope_qk

    def counted(q, k, cos, sin):
        calls.append(cos.dim())
        return real(q, k, cos, sin)

    monkeypatch.setattr(F, "fused_rope_qk", counted)
    steps = []
    for name in ("paged_decode", "paged_prefill_ragged"):
        step = getattr(tm, name)

        def recorded(*a, _step=step, _name=name, **kw):
            steps.append(_name)
            return _step(*a, **kw)

        monkeypatch.setattr(tm, name, recorded)
    eng = GenerationEngine(tm, **ENGINE_KW)
    rids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
    with torch.inference_mode():
        out = eng.run()
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(out[rid], w)
    assert eng.stats["ragged_steps"] > 0 and eng.stats["decode_tokens"] > 0
    assert set(steps) == {"paged_decode", "paged_prefill_ragged"}
    assert len(calls) == cfg.num_hidden_layers * len(steps)
    # decode steps pass [B, D] rows, ragged steps [C, Q, D]
    assert set(calls) == {2, 3}


def test_ctypes_argtypes_match_the_c_entry():
    """The wrapper's ctypes argument list has one type per parameter of
    ptt_rope in csrc/rope.cu, pointers where the C side takes pointers
    (ctypes passes a missing or mistyped argument without a check here:
    only the card would show it)."""
    import ctypes
    import pathlib
    import re

    from paddle_tpu_torch.ops.kernels import rope

    src = (pathlib.Path(rope.__file__).resolve().parents[2] / "csrc" /
           "rope.cu").read_text()
    params = re.search(r'extern "C" int ptt_rope\(([^)]*)\)', src).group(1)
    params = [p.strip() for p in params.split(",")]
    assert len(params) == len(rope._ARGS)
    for p, t in zip(params, rope._ARGS):
        if "*" in p:
            assert t is ctypes.c_void_p or issubclass(t, ctypes._Pointer), p
        elif p.startswith("long long"):
            assert t is ctypes.c_longlong, p
        else:
            assert p.startswith("int ") and t is ctypes.c_int, p
