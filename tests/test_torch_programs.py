"""The port's compiled step programs (``paddle_tpu_torch/inference/
programs.py``) against the JAX engine's compiled programs, on the CPU,
where every program runs eagerly through its static buffers (CUDA graphs
are the card's: ``chip_smoke.py`` ``[agree:graphs]``).

- the trace counters (``decode_trace_count``, ``prefill_trace_count``,
  ``ragged_trace_count``, ``copy_trace_count``, ``spec_trace_count``)
  equal the JAX engine's after the same workload, and a repeat wave of the
  same shapes leaves them unchanged: the ports of
  ``tests/test_generation_engine.py::
  test_chunked_decode_no_retrace_after_warmup`` and
  ``tests/test_speculative.py::test_zero_new_traces_on_repeat_shapes``
  (the draft model's engine included);
- greedy tokens equal the JAX engine's on the same weights and prompts;
- the CoW copy program: copies padded to a power of two with trash-page
  pairs (page 0 onto itself), int8 scale rows copied with their pages;
- ``swap_weights``: an in-place loader builds no program and gives a
  fresh engine's tokens; a loader that moves a parameter drops the
  programs, and the counters show the rebuilds;
- sampling through the runner: the exponential race equals
  ``torch.multinomial``'s draw, and a fixed seed gives the same tokens;
- ``PagedGenerationMixin.stream_generate`` yields the JAX package's
  tokens and restores the caller's grad mode between yields (the port of
  ``tests/test_serving_fastpath.py::
  test_stream_generate_releases_no_grad_between_tokens``);
- the launch-count bookkeeping a replay uses (``add_launch_counts``) and a
  program's refusal of a host array of another shape.

Tolerance: exact token and count equality (both engines run the same
float32 arithmetic up to summation order, far inside the tiny model's
greedy margins on these prompts).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import GenerationEngine as JaxEngine
from paddle_tpu.inference.speculative import \
    DraftModelDrafter as JaxDraftModelDrafter
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch import weights
from paddle_tpu_torch.inference import DraftModelDrafter, GenerationEngine
from paddle_tpu_torch.inference.engine import sample_tokens
from paddle_tpu_torch.inference.programs import TRACE_COUNTERS, Program
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

COUNTERS = tuple(TRACE_COUNTERS.values())
CHUNKED_KW = dict(max_slots=2, page_size=4, max_seq_len=64,
                  prefix_cache=True, prefill_chunk=8, mixed_step=True)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny())      # GQA: 4 q heads, 2 kv heads
    arrays = {n: np.asarray(p._value, np.float32)
              for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    weights.from_paddle_tpu_state(arrays, tm)
    return jm, tm


def _fresh_model(pair):
    """A port model with the pair's weights, for tests that change them."""
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(pair[1].state_dict())
    return tm


def _counts(eng):
    return tuple(getattr(eng, n) for n in COUNTERS)


def _wave(eng, prompts, n_new, **kw):
    rids = [eng.add_request(np.asarray(p), max_new_tokens=n_new, **kw)
            for p in prompts]
    out = eng.run()
    return [np.asarray(out[r]) for r in rids]


def _chunked_prompts():
    rng = np.random.default_rng(1)
    shared = rng.integers(1, 128, 12)          # 3 full pages of 4
    return [np.concatenate([shared, rng.integers(1, 128, 5)]),
            rng.integers(1, 128, 11), rng.integers(1, 128, 14),
            np.concatenate([shared, rng.integers(1, 128, 3)]),
            rng.integers(1, 128, 9)]


def _spec_prompts():
    return [np.array([1, 2, 3]), np.array([9, 8, 7, 6, 5, 4, 3]),
            np.array([5, 6, 7, 8] * 5), np.array([42, 17])]


def test_chunked_decode_no_retrace_after_warmup(pair):
    """Multi-step decode chunks: the counters equal the JAX engine's, and
    a repeat of the same-shaped workload builds nothing new."""
    jm, tm = pair
    prompts = [np.array([1, 2]), np.array([3, 4, 5, 6]),
               np.array([7, 8, 9])]
    engines = [JaxEngine(jm, max_slots=3, page_size=8),
               GenerationEngine(tm, max_slots=3, page_size=8)]
    outs, marks = [], []
    for eng in engines:
        outs.append(_wave(eng, prompts, 21))
        marks.append(_counts(eng))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert marks[0] == marks[1]
    assert marks[1][0] >= 1 and marks[1][1] >= 1   # decode and prefill
    for eng in engines:
        _wave(eng, prompts, 21)
    assert _counts(engines[1]) == marks[1]
    assert _counts(engines[0]) == marks[0]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_greedy_tokens_and_counters_equal_jax(pair, kv_dtype):
    """The prefix-sharing chunked workload (ragged, mixed and decode
    programs): tokens and every trace counter equal the JAX engine's
    (int8: as the TPU runs it, ``_dense_fallback = False``); a repeat
    wave (the prefix index dropped, so the shapes repeat) builds
    nothing."""
    jm, tm = pair
    prompts = _chunked_prompts()
    jeng = JaxEngine(jm, kv_dtype=kv_dtype, **CHUNKED_KW)
    jeng._dense_fallback = False
    teng = GenerationEngine(tm, kv_dtype=kv_dtype, **CHUNKED_KW)
    want, got = _wave(jeng, prompts, 10), _wave(teng, prompts, 10)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert _counts(teng) == _counts(jeng)
    assert teng.ragged_trace_count >= 2 and teng.decode_trace_count >= 2
    marks = _counts(teng)
    teng.blocks.invalidate_index()
    again = _wave(teng, prompts, 10)
    assert _counts(teng) == marks
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)


def test_zero_new_traces_on_repeat_shapes(pair):
    """Self-drafting: the verify programs, the target's and the draft
    model's engine's programs all freeze once the shapes repeat; tokens
    equal the JAX engine's spec-on tokens, and its counters."""
    jm, tm = pair
    kw = dict(max_slots=4, page_size=4, max_seq_len=96)
    eng = GenerationEngine(tm, spec_decode=DraftModelDrafter(tm), **kw)
    jeng = JaxEngine(jm, spec_decode=JaxDraftModelDrafter(jm), **kw)
    first = _wave(eng, _spec_prompts(), 16)
    for a, b in zip(first, _wave(jeng, _spec_prompts(), 16)):
        np.testing.assert_array_equal(a, b)
    second = _wave(eng, _spec_prompts(), 16)
    inner = eng._spec._eng
    marks = (_counts(eng), _counts(inner))
    assert eng.spec_trace_count >= 1
    assert inner.ragged_trace_count >= 1 and inner.decode_trace_count >= 1
    third = _wave(eng, _spec_prompts(), 16)
    for a, b in zip(second, third):
        np.testing.assert_array_equal(a, b)
    assert marks == (_counts(eng), _counts(inner))
    _wave(jeng, _spec_prompts(), 16)
    assert (eng.spec_trace_count, inner.ragged_trace_count,
            inner.decode_trace_count) == (
        jeng.spec_trace_count, jeng._spec._eng.ragged_trace_count,
        jeng._spec._eng.decode_trace_count)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cow_copy_program_pads_with_trash_pairs(pair, kv_dtype):
    """Three queued copies take the copy program of 4 pairs, the fourth
    page 0 onto itself: every pool's dst pages (and int8 scale rows) equal
    the src pages, the trash page and every other page are unchanged; a
    second flush of the same bucket builds nothing, another bucket does."""
    _, tm = pair
    eng = GenerationEngine(tm, kv_dtype=kv_dtype, **CHUNKED_KW)
    gen = torch.Generator().manual_seed(0)
    pools = [*eng.k_pages, *eng.v_pages, *(eng.k_scales or ()),
             *(eng.v_scales or ())]
    for pool in pools:
        if pool.dtype == torch.int8:
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=gen,
                                     dtype=torch.int8))
        else:
            pool.copy_(torch.rand(pool.shape, generator=gen))
    before = [p.clone() for p in pools]
    pairs = [(3, 7), (5, 8), (9, 2)]
    eng.blocks._pending_copies = list(pairs)
    eng._flush_cow()
    assert eng.copy_trace_count == 1
    prog = eng._programs._progs[("copy", (4,))]
    np.testing.assert_array_equal(prog.inputs["src"].numpy(), [3, 5, 9, 0])
    np.testing.assert_array_equal(prog.inputs["dst"].numpy(), [7, 8, 2, 0])
    dsts = [d for _, d in pairs]
    for pool, old in zip(pools, before):
        for src, dst in pairs:
            assert torch.equal(pool[dst], old[src])
        keep = [i for i in range(pool.shape[0]) if i not in dsts]
        assert torch.equal(pool[keep], old[keep])   # page 0 included
    assert len(pools) == (4 if kv_dtype else 2) * len(eng.k_pages)
    eng.blocks._pending_copies = [(1, 4)] * 4
    eng._flush_cow()
    assert eng.copy_trace_count == 1
    eng.blocks._pending_copies = [(1, 4)]
    eng._flush_cow()
    assert eng.copy_trace_count == 2 and eng.stats["cow_flushes"] == 3


def test_fork_runs_the_copy_program_and_keeps_tokens(pair):
    """A fork mid-decode copies the shared tail page through the copy
    program; parent and fork end with the JAX engine's tokens."""
    jm, tm = pair
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    outs = []
    for eng in (JaxEngine(jm, **CHUNKED_KW),
                GenerationEngine(tm, **CHUNKED_KW)):
        rid = eng.add_request(prompt, max_new_tokens=12)
        while len(eng._reqs[rid].out) < 4:
            eng.step()
        child = eng.fork_request(rid)
        out = eng.run()
        outs.append((out[rid], out[child], eng.copy_trace_count))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert outs[1][2] == outs[0][2] == 1


def test_swap_weights_keeps_programs_unless_a_parameter_moves(pair):
    """An in-place loader keeps every program (no counter moves) and the
    tokens equal a fresh engine's on the new weights; a loader that
    replaces a parameter's tensor drops the programs, which the next wave
    rebuilds (the counters show it), with a fresh engine's tokens."""
    tm = _fresh_model(pair)
    prompts = _chunked_prompts()
    eng = GenerationEngine(tm, **CHUNKED_KW)
    base = _wave(eng, prompts, 10)
    marks = _counts(eng)
    w = tm.llama.layers[0].self_attn.o_proj.weight
    eng.swap_weights(lambda: w.mul_(3.0), tag="b")
    assert _counts(eng) == marks and len(eng._programs) == sum(marks)
    swapped = _wave(eng, prompts, 10)
    assert _counts(eng) == marks
    fresh = _wave(GenerationEngine(tm, **CHUNKED_KW), prompts, 10)
    for a, b in zip(swapped, fresh):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(base, swapped))

    def move():
        w.data = w.data * (1.0 / 3.0)          # a new tensor: a new address

    eng.swap_weights(move, tag="c")
    assert len(eng._programs) == 0
    moved = _wave(eng, prompts, 10)
    assert _counts(eng) == tuple(2 * m for m in marks)
    fresh = _wave(GenerationEngine(tm, **CHUNKED_KW), prompts, 10)
    for a, b in zip(moved, fresh):
        np.testing.assert_array_equal(a, b)


def test_sampling_is_the_multinomial_draw():
    """sample_tokens' exponential race draws what torch.multinomial draws
    from the same generator state; greedy rows stay greedy."""
    logits = torch.randn(5, 97, generator=torch.Generator().manual_seed(1))
    temps = torch.tensor([0.7, 0.0, 1.3, 2.0, 0.0])
    got = sample_tokens(logits, temps, torch.Generator().manual_seed(3))
    safe = torch.where(temps > 0, temps, torch.ones_like(temps))
    probs = torch.softmax(logits / safe[:, None], dim=-1)
    want = torch.multinomial(probs, 1,
                             generator=torch.Generator().manual_seed(3))[:, 0]
    want = torch.where(temps > 0, want, torch.argmax(logits, dim=-1))
    assert torch.equal(got, want)


def test_sampled_tokens_reproducible_at_a_fixed_seed(pair):
    """Sampling programs (dense admission, ragged, decode) draw from the
    engine's generator: a fixed seed gives the same tokens on a fresh
    engine and after a reseed, building no new program; another seed
    gives other tokens."""
    _, tm = pair
    prompts = _chunked_prompts()
    runs = []
    for seed in (5, 5, 6):
        eng = GenerationEngine(tm, seed=seed, **CHUNKED_KW)
        runs.append(_wave(eng, prompts, 10, temperature=0.9))
    eng.reseed(6)
    marks = _counts(eng)
    eng.blocks.invalidate_index()
    again = _wave(eng, prompts, 10, temperature=0.9)
    assert _counts(eng) == marks
    assert eng.ragged_trace_count >= 2 and eng.decode_trace_count >= 2
    assert any(k[1][-1] for k in eng._programs._progs)   # sampling keys
    for a, b in zip(runs[0], runs[1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(runs[2], again):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(runs[0], runs[2]))


def test_stream_generate_equals_jax(pair):
    """stream_generate yields the JAX package's tokens, one at a time."""
    jm, tm = pair
    prompt = np.array([5, 6, 7, 8, 9, 10, 11])
    kw = dict(max_new_tokens=9, max_slots=2, page_size=4, max_seq_len=64)
    want = list(jm.stream_generate(prompt, **kw))
    got = list(tm.stream_generate(prompt, **kw))
    assert got == [int(t) for t in want] and len(got) == 9


def test_stream_generate_releases_no_grad_between_tokens(pair):
    """no_grad is entered per advance, not held across yields: caller code
    running between streamed tokens can still record a graph."""
    _, tm = pair
    assert torch.is_grad_enabled()
    toks = []
    x = torch.ones(2, requires_grad=True)
    for tok in tm.stream_generate(np.array([5, 6, 7]), max_new_tokens=4):
        assert torch.is_grad_enabled()      # restored while suspended
        assert (x * 2).requires_grad
        toks.append(tok)
    assert len(toks) == 4
    assert torch.is_grad_enabled()


def test_add_launch_counts_round_trip():
    """A replay adds the launches its capture recorded, under every key
    ``launch_counts`` has (wrappers, routes, parts); sign -1 takes them
    back."""
    start = K.launch_counts()
    delta = {"rms_norm": 3, "fused_rope.qk": 2,
             "ragged_paged_attention.sm90": 1, "ragged_paged_attention": 1}
    K.add_launch_counts(delta)
    mid = K.launch_counts()
    assert all(mid[k] == start[k] + n for k, n in delta.items())
    assert all(mid[k] == start[k] for k in start if k not in delta)
    K.add_launch_counts(delta, sign=-1)
    assert K.launch_counts() == start


def test_program_refuses_another_shape():
    """A program's static inputs have the shapes of its first use."""
    prog = Program(lambda inputs: inputs["x"] + 1,
                   {"x": np.zeros(4, np.int64)}, torch.device("cpu"))
    prog.load({"x": np.arange(4)})
    assert prog.fn(prog.inputs).tolist() == [1, 2, 3, 4]
    with pytest.raises(ValueError, match="shape"):
        prog.load({"x": np.arange(5)})
