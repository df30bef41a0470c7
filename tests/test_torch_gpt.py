"""The port's GPT against the JAX package's.

One tiny GPT (``GPTConfig.tiny()``: 2 layers, hidden 64, 4 heads of 16,
multi-head KV) made by the JAX package from seed 0, its weights bridged
with ``paddle_tpu_torch.weights``, float32 on the CPU.

- every JAX parameter name loads through ``weights.from_paddle_tpu_state``
  name for name, and the random init gives norm weights of ones and biases
  of zeros while Llama's draws stay bit-identical to the rule before GPT
  and BERT came (Llama's norm weights ones, everything else N(0, 0.02), in
  ``named_parameters`` order);
- the dense forward's logits and loss (labels with -100 ignored);
- each method of the paged contract (``paged_prefill``, ``paged_decode``,
  ``paged_prefill_ragged``, ``paged_verify``) on float and int8 pools:
  logits, and the pools and scale rows they write, against the JAX
  methods on the same inputs;
- ``generate_batch`` greedy tokens exactly equal to the JAX engine's with
  the prefix cache, chunked prefill, mixed steps and dense admission, on
  float pools and on int8 pools (the JAX int8 engine as the TPU runs it,
  ``_dense_fallback = False``); spec decoding with the n-gram and the
  draft-model drafters against the JAX engine's spec-on tokens; the
  model's ``generate`` against JAX's.

Tolerances: logits and losses 1e-4 of their largest value (the same
float32 arithmetic summed in other orders); float pools 1e-5; int8 codes
within 1 of JAX's at no more than 1 in 500 (a value within float32
rounding of a half-code boundary), scale rows rtol 1e-6; tokens exactly
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import speculative as jspec
from paddle_tpu.inference.engine import GenerationEngine as JaxEngine
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT

from paddle_tpu_torch import weights
from paddle_tpu_torch.inference import DraftModelDrafter, GenerationEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)

torch.set_num_threads(1)

ENGINE_KW = dict(max_slots=2, page_size=4, max_seq_len=64, prefix_cache=True,
                 prefill_chunk=8, mixed_step=True)
SPEC_KW = dict(max_slots=4, page_size=4, max_seq_len=64, mixed_step=False)
PAGE, N_PAGES, HEADS, HD, LAYERS = 4, 12, 4, 16, 2


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig.tiny())
    jm.eval()
    arrays = {n: np.asarray(p._value, np.float32)
              for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    weights.from_paddle_tpu_state(arrays, tm)
    return jm, tm


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_every_jax_parameter_loads_name_for_name(pair):
    jm, tm = pair
    want = {n: tuple(p.shape) for n, p in jm.named_parameters()}
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == want
    assert "gpt.h.0.mlp.2.weight" in got          # the Sequential's names
    state = weights.to_numpy_state(tm)
    for n, p in jm.named_parameters():
        np.testing.assert_array_equal(state[n], np.asarray(p._value))


def test_random_init_ones_for_norms_zeros_for_biases():
    tm = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    for state in (weights.random_state(tm, seed=3),
                  weights.to_numpy_state(weights.init_random_(tm, seed=3))):
        assert np.all(state["gpt.h.1.ln_1.weight"] == 1)
        assert np.all(state["gpt.ln_f.weight"] == 1)
        for name in ("gpt.h.0.ln_2.bias", "gpt.h.0.attn.qkv_proj.bias",
                     "gpt.h.1.mlp.0.bias"):
            assert np.all(state[name] == 0), name
        w = state["gpt.h.0.mlp.2.weight"]
        assert 0.015 < w.std() < 0.025 and abs(w.mean()) < 0.005


def _old_llama_rule(name):
    """Llama's init before GPT and BERT came: its norm weights 1, all else
    N(0, 0.02)."""
    if name.endswith("layernorm.weight") or name == "llama.norm.weight":
        return None
    return 0.02


def test_random_init_keeps_llama_draws_bit_identical():
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    rng = np.random.default_rng(7)
    want = {}
    for name, p in tm.named_parameters():
        std = _old_llama_rule(name)
        want[name] = np.ones(tuple(p.shape), np.float32) if std is None \
            else std * rng.standard_normal(tuple(p.shape), dtype=np.float32)
    got = weights.random_state(tm, seed=7)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    with torch.no_grad():
        ref = {}
        for name, p in tm.named_parameters():
            t = torch.empty_like(p)
            std = _old_llama_rule(name)
            ref[name] = t.fill_(1.0) if std is None else \
                t.normal_(0.0, std, generator=gen)
    weights.init_random_(tm, seed=7)
    for name, p in tm.named_parameters():
        assert torch.equal(p.detach(), ref[name]), name


def test_logits_and_loss_match_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 12))
    labels = rng.integers(0, 128, (2, 12))
    labels[1, 7:] = -100
    _close(tm(torch.from_numpy(ids)),
           jm(paddle.to_tensor(ids))._value)
    _close(tm(torch.from_numpy(ids), torch.from_numpy(labels)),
           jm(paddle.to_tensor(ids), paddle.to_tensor(labels))._value)


# ----------------------------------------------------------------------
# the paged contract, one call at a time
# ----------------------------------------------------------------------

def _pools(rng, int8):
    """Per-layer K and V pools [N, page, H, hd] and (int8) scale rows."""
    def pool():
        if int8:
            return rng.integers(-127, 128, (N_PAGES, PAGE, HEADS, HD),
                                dtype=np.int8)
        return rng.standard_normal((N_PAGES, PAGE, HEADS, HD),
                                   dtype=np.float32)
    kp = [pool() for _ in range(LAYERS)]
    vp = [pool() for _ in range(LAYERS)]
    if not int8:
        return kp, vp, None, None
    ks = [rng.uniform(0.5, 2.0, N_PAGES).astype(np.float32)
          for _ in range(LAYERS)]
    vs = [rng.uniform(0.5, 2.0, N_PAGES).astype(np.float32)
          for _ in range(LAYERS)]
    return kp, vp, ks, vs


def _call_both(jm, tm, method, host, pools, lead):
    """`method` on both models with the same host arrays, the pools after
    the first `lead` of them; the pools (and scale rows) as jnp arrays for
    JAX and as torch copies for the port. Returns (jax outputs, port
    outputs)."""
    kp, vp, ks, vs = pools
    jkw = {} if ks is None else dict(
        k_scales=[jnp.asarray(s) for s in ks],
        v_scales=[jnp.asarray(s) for s in vs])
    tkw = {} if ks is None else dict(
        k_scales=[torch.from_numpy(s.copy()) for s in ks],
        v_scales=[torch.from_numpy(s.copy()) for s in vs])
    j = getattr(jm, method)(*[jnp.asarray(a) for a in host[:lead]],
                            [jnp.asarray(p) for p in kp],
                            [jnp.asarray(p) for p in vp],
                            *[jnp.asarray(a) for a in host[lead:]], **jkw)
    with torch.inference_mode():
        t = getattr(tm, method)(
            *[torch.from_numpy(np.asarray(a)) for a in host[:lead]],
            [torch.from_numpy(p.copy()) for p in kp],
            [torch.from_numpy(p.copy()) for p in vp],
            *[torch.from_numpy(np.asarray(a)) for a in host[lead:]], **tkw)
    return j, t


def _same_pools(j, t, int8):
    """Pools (and scale rows) after a call, the trash page 0 aside (the
    padding writes land there in both, in any order)."""
    for jp, tp in zip(j[1] + j[2], t[1] + t[2]):
        if not int8:
            np.testing.assert_allclose(tp.numpy()[1:], np.asarray(jp)[1:],
                                       rtol=0, atol=1e-5)
            continue
        diff = tp.numpy()[1:].astype(np.int32) - np.asarray(jp)[1:]
        assert np.abs(diff).max() <= 1
        assert np.count_nonzero(diff) * 500 <= diff.size
    if int8:
        for js, ts in zip(j[3] + j[4], t[3] + t[4]):
            np.testing.assert_allclose(ts.numpy()[1:], np.asarray(js)[1:],
                                       rtol=1e-6)


BT = np.array([[1, 2, 3, 4] + [0] * 12, [5, 6, 7, 8] + [0] * 12], np.int32)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_paged_decode_matches_jax(pair, int8):
    """Two slots decode one token each: slot 1's position 8 opens its
    page (offset 0), so an int8 call freezes that page's scale."""
    jm, tm = pair
    rng = np.random.default_rng(1)
    pools = _pools(rng, int8)
    tokens = np.array([17, 99], np.int64)
    pos = np.array([6, 8], np.int64)
    ctx = (pos + 1).astype(np.int32)
    wpid = BT[np.arange(2), pos // PAGE].astype(np.int64)
    woff = pos % PAGE
    j, t = _call_both(jm, tm, "paged_decode",
                      (tokens, pos, BT, ctx, wpid, woff), pools, 2)
    _close(t[0], j[0])
    _same_pools(j, t, int8)


def _ragged_host():
    """Row 0: 4 tokens at positions 3-6 (crossing a page); row 1: one
    token at position 9; padding columns write the trash page 0."""
    ids = np.array([[5, 6, 7, 8], [42, 0, 0, 0]], np.int64)
    q_lens = np.array([4, 1], np.int32)
    start = np.array([3, 9], np.int32)
    wpid = np.zeros((2, 4), np.int64)
    woff = np.zeros((2, 4), np.int64)
    for r in range(2):
        p = start[r] + np.arange(q_lens[r])
        wpid[r, :q_lens[r]] = BT[r, p // PAGE]
        woff[r, :q_lens[r]] = p % PAGE
    return ids, q_lens, start, BT, wpid, woff


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("method", ["paged_prefill_ragged", "paged_verify"])
def test_paged_ragged_and_verify_match_jax(pair, method, int8):
    jm, tm = pair
    rng = np.random.default_rng(2)
    pools = _pools(rng, int8)
    host = _ragged_host()
    q_lens = host[1]
    j, t = _call_both(jm, tm, method, host, pools, 3)
    if method == "paged_verify":
        for r in range(2):           # positions past q_len are padding
            _close(t[0][r, :q_lens[r]], np.asarray(j[0])[r, :q_lens[r]])
    else:
        _close(t[0], j[0])
    _same_pools(j, t, int8)


def test_paged_prefill_matches_jax(pair):
    """The dense admission: last-real-token logits and every layer's K/V
    [L, C, S_pad, H, hd]."""
    jm, tm = pair
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 128, (4, 8))
    lens = np.array([7, 3, 8, 1], np.int32)
    jl, jk, jv = jm.paged_prefill(jnp.asarray(ids), jnp.asarray(lens))
    with torch.inference_mode():
        tl, tk, tv = tm.paged_prefill(torch.from_numpy(ids),
                                      torch.from_numpy(lens))
    assert tuple(tk.shape) == (LAYERS, 4, 8, HEADS, HD)
    _close(tl, jl)
    _close(tk, jk, 1e-5)
    _close(tv, jv, 1e-5)


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------

def _mixed_prompts():
    """Cold prompts no longer than the chunk of 8 (dense admission), a
    long cold prompt (chunked prefill) and two sharing an 8-token prefix,
    the second arriving after the first is indexed (a ragged suffix)."""
    rng = np.random.default_rng(2)
    shared = rng.integers(1, 128, 8)
    prompts = [np.concatenate([shared, rng.integers(1, 128, 2)]),
               rng.integers(1, 128, 5), rng.integers(1, 128, 8),
               np.concatenate([shared, rng.integers(1, 128, 3)]),
               rng.integers(1, 128, 13), rng.integers(1, 128, 3)]
    return [p.astype(np.int32) for p in prompts]


def _jax_engine(jm, kv_dtype=None, **kw):
    eng = JaxEngine(jm, kv_dtype=kv_dtype, **kw)
    if kv_dtype == "int8":
        eng._dense_fallback = False    # the TPU program's int8 decode
    return eng


def _drive(eng, prompts, n_new, jax=False):
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    if jax:
        out = eng.run()
    else:
        with torch.inference_mode():
            out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("kv", [None, "int8"], ids=["float", "int8"])
def test_generate_batch_greedy_parity_with_jax_engine(pair, kv):
    """Dense admissions, chunked and suffix ragged prefill after a prefix
    hit, mixed steps and decode chunks, float or int8 pools: tokens equal
    the JAX engine's."""
    jm, tm = pair
    prompts = _mixed_prompts()
    want = _drive(_jax_engine(jm, kv, **ENGINE_KW), prompts, 10, jax=True)
    eng = GenerationEngine(tm, kv_dtype=kv, **ENGINE_KW)
    got = _drive(eng, prompts, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    st = eng.stats
    assert st["prefill_admits"] > 0 and st["ragged_steps"] > 0
    assert st["prefix_hits"] == 1 and st["prefix_hit_tokens"] == 8
    assert st["mixed_decode_tokens"] > 0 and st["decode_chunks"] > 0
    assert eng.k_pages[0].shape[2] == HEADS      # MHA: a KV head a head
    assert np.all(eng.blocks.refcount[1:] == 0)
    if kv is None:           # the model's front door
        for g, w in zip(tm.generate_batch(prompts, max_new_tokens=10,
                                          **ENGINE_KW), want):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def spec_refs(pair):
    """The JAX engine's spec-off tokens of the spec workload."""
    return _drive(JaxEngine(pair[0], **SPEC_KW), _spec_prompts(), 16,
                  jax=True)


def _spec_prompts():
    return [np.array([1, 2, 3]), np.array([9, 8, 7, 6, 5, 4, 3]),
            np.tile(np.array([5, 6, 7, 8]), 5), np.array([42, 17])]


@pytest.mark.parametrize("kv", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("kind", ["ngram", "draft_model"])
def test_spec_decoding_matches_jax_spec_on_tokens(pair, spec_refs, kind, kv):
    """Spec-on tokens equal the JAX engine's spec-on tokens with the same
    drafter (and, on float pools, the spec-off tokens); the drafter
    drafted."""
    jm, tm = pair
    jd, td = ("ngram", "ngram") if kind == "ngram" else (
        jspec.DraftModelDrafter(jm), DraftModelDrafter(tm))
    prompts = _spec_prompts()
    want = _drive(_jax_engine(jm, kv, spec_decode=jd, **SPEC_KW), prompts,
                  16, jax=True)
    eng = GenerationEngine(tm, kv_dtype=kv, spec_decode=td, **SPEC_KW)
    got = _drive(eng, prompts, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if kv is None:
        for g, w in zip(got, spec_refs):
            np.testing.assert_array_equal(g, w)
    assert eng.stats["spec_dispatches"] > 0
    assert eng.stats["spec_draft_tokens"] > 0


def test_generate_matches_jax(pair):
    jm, tm = pair
    ids = np.random.default_rng(4).integers(1, 128, (2, 6))
    want = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=8)
                      ._value)
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=8)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, 14)
    np.testing.assert_array_equal(got.numpy(), want)
