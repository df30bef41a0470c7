"""The port's Llama against the JAX package's, with bridged weights.

``paddle_tpu_torch.weights.from_paddle_tpu_state`` copies the JAX model's
parameters (numpy, under the JAX names) into the port's model; the dense
causal ``forward``, the dense ``paged_prefill`` (right-padded rows and a
dummy length-1 row), and the two paged serving steps of the contract —
``paged_prefill_ragged`` (mixed prefill-at-tail, decode and dummy rows) and
``paged_decode`` (with an idle slot) — then get the same numpy inputs on
both sides, and the logits, the prefill's K/V and the written page pools
must agree. ``generate`` with and without its KV cache gives the JAX
``generate``'s greedy tokens, and the loss with labels is the JAX model's
fused loss. With a padded-batch attention mask the logits, the loss and
every parameter's gradient match the JAX model's, and attention dropout
is checked by its statistics. The two paged steps also run over int8 pools
with per-page scale rows (``k_scales``/``v_scales``): the logits, the
written codes and the scale rows must agree with the JAX Llama's.

Tolerance: float32, atol 1e-4 on logits, K/V and pools — the same float32
products summed in other orders by two BLAS libraries and the attention
formulations, through 2 layers; the bridge itself is bit-exact. Tokens:
exact equality (logit gaps on these prompts are far above 1e-4). int8
pools: scale rows rtol 1e-6 (an absmax of K/V rows that agree to float32
rounding); codes equal except where a value lies within that rounding of
a half-code boundary, where they may differ by 1 — such codes are
counted, and at most 1 in 500 written codes may differ.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.core.dispatch import no_grad
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch import weights
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

ATOL = 1e-4
PAGE, N_PAGES = 4, 16


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny())      # GQA: 4 q heads, 2 kv heads
    jm.eval()
    arrays = {n: np.asarray(p._value, np.float32)
              for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    weights.from_paddle_tpu_state(arrays, tm)
    return jm, tm, arrays


def _pools(rng, n_layers, kv_heads, hd):
    shape = (N_PAGES, PAGE, kv_heads, hd)
    return ([rng.standard_normal(shape).astype(np.float32)
             for _ in range(n_layers)],
            [rng.standard_normal(shape).astype(np.float32)
             for _ in range(n_layers)])


def _check_pools(jax_pools, port_pools):
    for a, b in zip(jax_pools, port_pools):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)


def test_weight_bridge_round_trip(pair):
    """Same names, same shapes, bit-equal values; a wrong name or shape
    is refused."""
    _, tm, arrays = pair
    back = weights.to_numpy_state(tm)
    assert sorted(back) == sorted(arrays)
    for name, arr in arrays.items():
        assert back[name].shape == arr.shape
        assert np.array_equal(back[name], arr), name
    with pytest.raises(KeyError):
        weights.from_paddle_tpu_state(
            {**arrays, "llama.extra.weight": arrays["llama.norm.weight"]},
            tm)
    bad = dict(arrays)
    bad["llama.norm.weight"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        weights.from_paddle_tpu_state(bad, tm)
    weights.from_paddle_tpu_state(arrays, tm)


def test_dense_forward_logits_match_jax(pair):
    """The dense causal forward (flash attention, fused RoPE) under the
    bridged weights: the same parameter names serve it."""
    jm, tm, _ = pair
    ids = np.random.default_rng(4).integers(
        0, tm.config.vocab_size, (2, 11)).astype(np.int32)
    with no_grad():
        want = np.asarray(jm(paddle.to_tensor(ids))._value)
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids).long())
    assert got.shape == (2, 11, tm.config.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_paged_prefill_logits_and_kv_match_jax(pair):
    jm, tm, _ = pair
    cfg = tm.config
    rng = np.random.default_rng(5)
    c, s_pad = 4, 16
    lengths = np.array([16, 9, 3, 1], np.int32)   # last row: a dummy
    ids = np.zeros((c, s_pad), np.int32)
    for i, n in enumerate(lengths[:3]):
        ids[i, :n] = rng.integers(1, cfg.vocab_size, n)
    with no_grad():
        jl, jk, jv = jm.paged_prefill(jnp.asarray(ids), jnp.asarray(lengths))
    with torch.inference_mode():
        tl, tk, tv = tm.paged_prefill(torch.from_numpy(ids).long(),
                                      torch.from_numpy(lengths))
    hd = cfg.hidden_size // cfg.num_attention_heads
    assert tk.shape == (cfg.num_hidden_layers, c, s_pad,
                        cfg.num_key_value_heads, hd)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


@pytest.mark.parametrize("use_cache", [True, False],
                         ids=["cache", "recompute"])
def test_generate_greedy_tokens_match_jax(pair, use_cache):
    jm, tm, _ = pair
    ids = np.random.default_rng(6).integers(
        1, tm.config.vocab_size, (2, 7)).astype(np.int32)
    want = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=8,
                                  use_cache=use_cache)._value)
    got = tm.generate(ids, max_new_tokens=8, use_cache=use_cache)
    assert got.dtype == torch.int32 and got.shape == (2, 15)
    np.testing.assert_array_equal(got.numpy(), want)


def _padded_batch(rng, vocab):
    """ids [2, 9] and a padded-batch mask [2, 1, 9, 9] (causal, keys past
    each row's length 9 / 6 hidden), as numpy."""
    ids = rng.integers(0, vocab, (2, 9)).astype(np.int32)
    pos = np.arange(9)
    lens = np.array([9, 6])
    mask = (pos[None, :] <= pos[:, None])[None, None] & \
        (pos[None, None, None, :] < lens[:, None, None, None])
    return ids, mask


def test_paths_of_later_slices_raise(pair):
    """The paths that earlier slices refused are served now: the loss
    (labels) equals the JAX model's fused loss, an attention mask gives
    the JAX model's logits, and attention dropout while training runs
    (outside training it is off)."""
    from paddle_tpu_torch.nn import functional as F
    jm, tm, _ = pair
    rng = np.random.default_rng(8)
    ids = rng.integers(0, tm.config.vocab_size, (2, 9)).astype(np.int32)
    labels = rng.integers(0, tm.config.vocab_size, (2, 9)).astype(np.int32)
    with no_grad():
        want = float(jm(paddle.to_tensor(ids),
                        labels=paddle.to_tensor(labels)).numpy())
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, atol=1e-5)
    ids, mask = _padded_batch(rng, tm.config.vocab_size)
    with no_grad():
        want = np.asarray(jm(paddle.to_tensor(ids),
                             attn_mask=paddle.to_tensor(mask))._value)
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids), attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    q = torch.ones(1, 4, 2, 8)
    out = F.scaled_dot_product_attention(q, q, q, dropout_p=0.1,
                                         training=True)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    out = F.scaled_dot_product_attention(q, q, q, dropout_p=0.1,
                                         training=False)
    assert torch.equal(out, F.scaled_dot_product_attention(q, q, q))


def test_masked_loss_and_grads_match_jax(pair):
    """A padded batch with its attention mask: the loss and every
    parameter's gradient against the JAX model's."""
    jm, tm, _ = pair
    rng = np.random.default_rng(12)
    ids, mask = _padded_batch(rng, tm.config.vocab_size)
    labels = rng.integers(0, tm.config.vocab_size, (2, 9)).astype(np.int32)
    labels[1, 6:] = -100                    # the padding scores nothing
    jl = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels),
            attn_mask=paddle.to_tensor(mask))
    jl.backward()
    j_grads = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()}
    jm.clear_gradients()
    tl = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels),
            attn_mask=torch.from_numpy(mask))
    tl.backward()
    t_grads = {n: p.grad.numpy().copy() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), atol=1e-5)
    assert sorted(t_grads) == sorted(j_grads)
    for n, want in j_grads.items():
        np.testing.assert_allclose(t_grads[n], want, atol=1e-5, rtol=1e-4,
                                   err_msg=n)


def test_attention_dropout_statistics():
    """SDPA dropout while training, seen through one-hot values (out =
    the dropped probabilities): about p of them are 0 (within 5 sigma) and
    the others are _sdpa_xla's probabilities divided by 1 - p."""
    from paddle_tpu.nn.functional.attention import _sdpa_xla
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.default_rng(14)
    b, s, h, p = 2, 64, 2, 0.3
    q = rng.standard_normal((b, s, h, 16)).astype(np.float32)
    k = rng.standard_normal((b, s, 1, 16)).astype(np.float32)
    v = np.broadcast_to(np.eye(s, dtype=np.float32)[None, :, None, :],
                        (b, s, 1, s)).copy()
    probs = np.asarray(_sdpa_xla(*map(jnp.asarray, (q, k, v)),
                                 training=False))
    gen = torch.Generator().manual_seed(0)
    out = F.scaled_dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                         dropout_p=p, training=True,
                                         generator=gen).numpy()
    dropped = out == 0
    rate = dropped.mean()
    assert abs(rate - p) <= 5 * np.sqrt(p * (1 - p) / out.size)
    np.testing.assert_allclose(out[~dropped], probs[~dropped] / (1 - p),
                               rtol=1e-5, atol=1e-7)


def test_paged_prefill_ragged_logits_match_jax(pair):
    jm, tm, _ = pair
    cfg = tm.config
    hd = cfg.hidden_size // cfg.num_attention_heads
    rng = np.random.default_rng(0)
    c, q, p_max = 4, 8, 6
    ids = rng.integers(0, cfg.vocab_size, (c, q)).astype(np.int32)
    # a first chunk, a chunk at the tail of 7 cached tokens (ending
    # mid-page), a decode row, a dummy row on the trash page
    q_lens = np.array([8, 5, 1, 1], np.int32)
    start = np.array([0, 7, 3, 0], np.int32)
    bt = np.zeros((c, p_max), np.int32)
    bt[0, :2], bt[1, :3], bt[2, :1] = [1, 2], [3, 4, 5], [6]
    wp = np.zeros((c, q), np.int32)
    wo = np.zeros((c, q), np.int32)
    for r in range(3):
        for i in range(q_lens[r]):
            pos = start[r] + i
            wp[r, i], wo[r, i] = bt[r, pos // PAGE], pos % PAGE
    kp, vp = _pools(rng, cfg.num_hidden_layers, cfg.num_key_value_heads, hd)
    with no_grad():
        jl, jk, jv = jm.paged_prefill_ragged(
            jnp.asarray(ids), jnp.asarray(q_lens), jnp.asarray(start),
            [jnp.asarray(a) for a in kp], [jnp.asarray(a) for a in vp],
            jnp.asarray(bt), jnp.asarray(wp), jnp.asarray(wo))
    tk = [torch.from_numpy(a.copy()) for a in kp]
    tv = [torch.from_numpy(a.copy()) for a in vp]
    with torch.inference_mode():
        tl, tk2, tv2 = tm.paged_prefill_ragged(
            torch.from_numpy(ids).long(), torch.from_numpy(q_lens),
            torch.from_numpy(start), tk, tv, torch.from_numpy(bt),
            torch.from_numpy(wp).long(), torch.from_numpy(wo).long())
    assert tk2 is tk and tv2 is tv               # written in place
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3],
                               atol=ATOL)
    _check_pools(jk, tk)
    _check_pools(jv, tv)


def test_paged_decode_logits_match_jax(pair):
    jm, tm, _ = pair
    cfg = tm.config
    hd = cfg.hidden_size // cfg.num_attention_heads
    rng = np.random.default_rng(1)
    b, p_max = 3, 6
    tokens = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
    positions = np.array([9, 4, 0], np.int32)     # slot 2 is idle
    bt = np.zeros((b, p_max), np.int32)
    bt[0, :3], bt[1, :2] = [1, 2, 3], [4, 5]
    ctx = np.array([10, 5, 0], np.int32)
    wp = np.array([3, 5, 0], np.int32)
    wo = positions % PAGE * (ctx > 0)
    kp, vp = _pools(rng, cfg.num_hidden_layers, cfg.num_key_value_heads, hd)
    with no_grad():
        jl, jk, jv = jm.paged_decode(
            jnp.asarray(tokens), jnp.asarray(positions),
            [jnp.asarray(a) for a in kp], [jnp.asarray(a) for a in vp],
            jnp.asarray(bt), jnp.asarray(ctx), jnp.asarray(wp),
            jnp.asarray(wo))
    tk = [torch.from_numpy(a.copy()) for a in kp]
    tv = [torch.from_numpy(a.copy()) for a in vp]
    with torch.inference_mode():
        tl, _, _ = tm.paged_decode(
            torch.from_numpy(tokens).long(),
            torch.from_numpy(positions).long(), tk, tv,
            torch.from_numpy(bt), torch.from_numpy(ctx),
            torch.from_numpy(wp).long(), torch.from_numpy(wo).long())
    # the idle slot's attention output is 0 on the port and the kernels,
    # a uniform average in the JAX gather reference: compare live slots
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                               atol=ATOL)
    for pools_j, pools_t in ((jk, tk), (jv, tv)):
        for a, t in zip(pools_j, pools_t):
            np.testing.assert_allclose(t.numpy()[1:], np.asarray(a)[1:],
                                       atol=ATOL)


def _int8_pools(rng, n_layers, kv_heads, hd):
    shape = (N_PAGES, PAGE, kv_heads, hd)
    return [[rng.integers(-127, 128, shape).astype(np.int8)
             for _ in range(n_layers)] for _ in range(2)], \
        [[(0.5 + rng.random(N_PAGES)).astype(np.float32)
          for _ in range(n_layers)] for _ in range(2)]


def _check_int8(jax_out, pools, scales, n_written):
    """Scale rows and codes against the JAX step's outputs (page 0 is the
    trash page: rows of several slots land on its offset 0)."""
    _, jk, jv, jks, jvs = jax_out
    off_by_one = 0
    for jp, tp in zip(jk + jv, pools[0] + pools[1]):
        diff = tp.numpy()[1:].astype(np.int32) - np.asarray(jp)[1:]
        assert np.abs(diff).max() <= 1
        off_by_one += int(np.count_nonzero(diff))
    assert off_by_one * 500 <= n_written
    for js, ts in zip(jks + jvs, scales[0] + scales[1]):
        np.testing.assert_allclose(ts.numpy()[1:], np.asarray(js)[1:],
                                   rtol=1e-6)


def test_paged_prefill_ragged_int8_matches_jax(pair):
    """The ragged step over int8 pools: page 1-2 and 5 opened by chunks,
    appends at offset > 0 into pages 4 and 6 clip against their frozen
    scales, a dummy row and padding on the trash page."""
    jm, tm, _ = pair
    cfg = tm.config
    hd = cfg.hidden_size // cfg.num_attention_heads
    rng = np.random.default_rng(2)
    c, q, p_max = 4, 8, 6
    ids = rng.integers(0, cfg.vocab_size, (c, q)).astype(np.int32)
    q_lens = np.array([8, 5, 1, 1], np.int32)
    start = np.array([0, 7, 3, 0], np.int32)
    bt = np.zeros((c, p_max), np.int32)
    bt[0, :2], bt[1, :3], bt[2, :1] = [1, 2], [3, 4, 5], [6]
    wp = np.zeros((c, q), np.int32)
    wo = np.zeros((c, q), np.int32)
    for r in range(3):
        for i in range(q_lens[r]):
            pos = start[r] + i
            wp[r, i], wo[r, i] = bt[r, pos // PAGE], pos % PAGE
    (kp, vp), (ks, vs) = _int8_pools(rng, cfg.num_hidden_layers,
                                     cfg.num_key_value_heads, hd)
    with no_grad():
        jout = jm.paged_prefill_ragged(
            jnp.asarray(ids), jnp.asarray(q_lens), jnp.asarray(start),
            [jnp.asarray(a) for a in kp], [jnp.asarray(a) for a in vp],
            jnp.asarray(bt), jnp.asarray(wp), jnp.asarray(wo),
            k_scales=[jnp.asarray(a) for a in ks],
            v_scales=[jnp.asarray(a) for a in vs])
    pools = [[torch.from_numpy(a.copy()) for a in x] for x in (kp, vp)]
    scales = [[torch.from_numpy(a.copy()) for a in x] for x in (ks, vs)]
    with torch.inference_mode():
        tout = tm.paged_prefill_ragged(
            torch.from_numpy(ids).long(), torch.from_numpy(q_lens),
            torch.from_numpy(start), *pools, torch.from_numpy(bt),
            torch.from_numpy(wp).long(), torch.from_numpy(wo).long(),
            k_scales=scales[0], v_scales=scales[1])
    assert len(tout) == 5 and tout[3] is scales[0] and tout[1] is pools[0]
    np.testing.assert_allclose(tout[0].numpy()[:3], np.asarray(jout[0])[:3],
                               atol=ATOL)
    n_written = 2 * cfg.num_hidden_layers * int(q_lens[:3].sum()) * \
        cfg.num_key_value_heads * hd
    _check_int8(jout, pools, scales, n_written)
    assert float(scales[0][0][1]) != float(ks[0][1])     # page 1 opened
    assert float(scales[0][0][4]) == float(ks[0][4])     # page 4 frozen


def test_paged_decode_int8_matches_jax(pair):
    """The decode step over int8 pools: slot 0 appends at offset 1 of page
    3 (frozen scale), slot 1 opens page 5, slot 2 is idle (trash page)."""
    jm, tm, _ = pair
    cfg = tm.config
    hd = cfg.hidden_size // cfg.num_attention_heads
    rng = np.random.default_rng(3)
    b, p_max = 3, 6
    tokens = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
    positions = np.array([9, 4, 0], np.int32)
    bt = np.zeros((b, p_max), np.int32)
    bt[0, :3], bt[1, :2] = [1, 2, 3], [4, 5]
    ctx = np.array([10, 5, 0], np.int32)
    wp = np.array([3, 5, 0], np.int32)
    wo = positions % PAGE * (ctx > 0)
    (kp, vp), (ks, vs) = _int8_pools(rng, cfg.num_hidden_layers,
                                     cfg.num_key_value_heads, hd)
    with no_grad():
        jout = jm.paged_decode(
            jnp.asarray(tokens), jnp.asarray(positions),
            [jnp.asarray(a) for a in kp], [jnp.asarray(a) for a in vp],
            jnp.asarray(bt), jnp.asarray(ctx), jnp.asarray(wp),
            jnp.asarray(wo), k_scales=[jnp.asarray(a) for a in ks],
            v_scales=[jnp.asarray(a) for a in vs])
    pools = [[torch.from_numpy(a.copy()) for a in x] for x in (kp, vp)]
    scales = [[torch.from_numpy(a.copy()) for a in x] for x in (ks, vs)]
    with torch.inference_mode():
        tout = tm.paged_decode(
            torch.from_numpy(tokens).long(),
            torch.from_numpy(positions).long(), *pools,
            torch.from_numpy(bt), torch.from_numpy(ctx),
            torch.from_numpy(wp).long(), torch.from_numpy(wo).long(),
            k_scales=scales[0], v_scales=scales[1])
    assert len(tout) == 5
    # live slots only: the JAX reference averages the idle slot
    np.testing.assert_allclose(tout[0].numpy()[:2], np.asarray(jout[0])[:2],
                               atol=ATOL)
    _check_int8(jout, pools, scales,
                2 * cfg.num_hidden_layers * 2 * cfg.num_key_value_heads * hd)
    assert float(scales[0][0][3]) == float(ks[0][3])     # frozen
    assert float(scales[0][0][5]) != float(ks[0][5])     # opened
