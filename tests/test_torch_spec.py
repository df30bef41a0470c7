"""The port's speculative decoding against the JAX engine's.

One tiny Llama (``LlamaConfig.tiny()``, seed 0) in both packages, its
weights bridged with ``paddle_tpu_torch.weights``, float32, pages of 4 (so
verify windows cross page boundaries often). One module-scoped JAX
spec-off run of 24 new tokens over four prompts is the reference that the
other budgets slice, as ``tests/test_speculative.py`` does.

- spec-on tokens equal spec-off tokens and the JAX engine's spec-on
  tokens for ``"ngram"``, ``DraftModelDrafter(model)`` and an oracle
  drafter, over float and int8 pages (the JAX int8 engine as the TPU runs
  it: ``_dense_fallback = False``); the port's drafted, accepted and
  rollback counts equal the JAX counters' deltas of the same run;
- the budget and EOS are honoured mid-bundle; a wrong-token drafter
  collapses every slot into its cooldown and falls back to the plain
  chunk without changing a token; a long prompt chunks through the ragged
  program while running slots commit spec bundles; preemption on an
  oversubscribed pool mid-spec keeps the tokens and returns every page;
- the ``PADDLE_TPU_SPEC_DECODE`` flag and ``make_drafter``: an ambient bad
  or unusable value serves plain, an explicit one raises; the draft
  model's private engine stays spec-off under the flag;
- ``NgramDrafter`` proposes what the JAX one proposes; a drafter's
  ``history_window`` bounds what the engine copies;
- ``BlockManager.trim`` and ``invalidate_index``: the port's and the JAX
  package's block managers give equal tables, refcounts, free and cached
  pools over one seeded random sequence of assign, fork, trim, register,
  match and invalidate operations.

Tolerance: exact token and count equality (both engines run the same
float32 arithmetic up to summation order, far inside the tiny model's
greedy margins on these prompts).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import speculative as jspec
from paddle_tpu.inference.engine import BlockManager as JaxBlockManager
from paddle_tpu.inference.engine import GenerationEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability.metrics import REGISTRY

from paddle_tpu_torch import weights
from paddle_tpu_torch.inference import (BlockManager, DraftModelDrafter,
                                        Drafter, GenerationEngine,
                                        NgramDrafter, make_drafter,
                                        spec_decode_from_env)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

KW = dict(max_slots=4, page_size=4, max_seq_len=96, mixed_step=False)
JAX_COUNTERS = ("spec_draft_tokens_total", "spec_accepted_tokens_total",
                "spec_rollbacks_total")
PORT_STATS = ("spec_draft_tokens", "spec_accepted_tokens", "spec_rollbacks")


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny())      # GQA: 4 q heads, 2 kv heads
    arrays = {n: np.asarray(p._value, np.float32)
              for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    weights.from_paddle_tpu_state(arrays, tm)
    return jm, tm


def _prompts():
    return [np.array([1, 2, 3]), np.array([9, 8, 7, 6, 5, 4, 3]),
            np.tile(np.array([5, 6, 7, 8]), 5), np.array([42, 17])]


def _jax_engine(jm, kv_dtype=None, **kw):
    eng = JaxEngine(jm, kv_dtype=kv_dtype, **kw)
    if kv_dtype == "int8":
        eng._dense_fallback = False    # the TPU program's int8 decode
    return eng


def _drive(eng, prompts, n_new, eos=None, jax=False):
    rids = [eng.add_request(p, max_new_tokens=n_new, eos_token_id=eos)
            for p in prompts]
    if jax:
        out = eng.run()
    else:
        with torch.inference_mode():
            out = eng.run()
    return [out[r] for r in rids]


def _run(tm, prompts, n_new, eos=None, **kw):
    eng = GenerationEngine(tm, **dict(KW, **kw))
    return eng, _drive(eng, prompts, n_new, eos)


@pytest.fixture(scope="module")
def refs24(pair):
    """ONE JAX spec-off run of 24 new tokens: greedy decode makes every
    shorter budget's output a prefix of it."""
    return _drive(JaxEngine(pair[0], **KW), _prompts(), 24, jax=True)


def _ref(refs24, n_new, count=None):
    ps = _prompts()[:count] if count else _prompts()
    return [r[:len(p) + n_new] for p, r in zip(ps, refs24)]


def _jax_counters():
    c = REGISTRY.snapshot()["counters"]
    return {k: c.get(k, 0) for k in JAX_COUNTERS}


class OracleDrafter(Drafter):
    """Proposes the true continuation of whichever reference sequence the
    committed tokens prefix: every draft verifies."""

    name = "oracle"

    def __init__(self, refs):
        self.refs = [np.asarray(r) for r in refs]

    def propose(self, live, k):
        out = {}
        for slot, toks in live.items():
            toks = np.asarray(toks)
            for ref in self.refs:
                if toks.size < ref.size and np.array_equal(
                        ref[:toks.size], toks):
                    d = ref[toks.size: toks.size + k]
                    if d.size:
                        out[slot] = [int(x) for x in d]
                    break
        return out


class WrongDrafter(OracleDrafter):
    """Proposes the true continuation shifted by one modulo the vocabulary:
    every draft is rejected."""

    name = "wrong"

    def propose(self, live, k):
        return {s: [(t + 1) % 128 for t in d]
                for s, d in OracleDrafter.propose(self, live, k).items()}


def _drafters(kind, jm, tm, refs):
    """(JAX drafter, port drafter) of one kind."""
    if kind == "ngram":
        return "ngram", "ngram"
    if kind == "draft_model":
        return jspec.DraftModelDrafter(jm), DraftModelDrafter(tm)
    jax_oracle = type("JaxOracle", (jspec.Drafter,),
                      {"name": "oracle", "propose": OracleDrafter.propose})()
    jax_oracle.refs = [np.asarray(r) for r in refs]
    return jax_oracle, OracleDrafter(refs)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("kind", ["ngram", "draft_model", "oracle"])
def test_spec_tokens_and_counts_equal_jax(pair, refs24, kind, kv):
    """Spec-on tokens equal spec-off tokens and the JAX engine's spec-on
    tokens; drafted, accepted and rollbacks equal the JAX counters'."""
    jm, tm = pair
    prompts = _prompts()
    jd, td = _drafters(kind, jm, tm, refs24)
    c0 = _jax_counters()
    want = _drive(_jax_engine(jm, kv, spec_decode=jd, **KW), prompts, 24,
                  jax=True)
    c1 = _jax_counters()
    eng, got = _run(tm, prompts, 24, spec_decode=td, kv_dtype=kv)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if kv is None:
        for g, o in zip(got, refs24):
            np.testing.assert_array_equal(g, o)
    else:
        # int8: a verify window that opens a page freezes its scale over
        # every row of the window in it (a decode step: its one row), so
        # spec-on tokens may leave the spec-off ones; the JAX engine does
        # the same (equal above), within test_kv_int8's 25% budget
        off = _run(tm, prompts, 24, kv_dtype=kv)[1]
        diff = sum(int(np.count_nonzero(g != o)) for g, o in zip(got, off))
        assert diff <= 0.25 * 24 * len(prompts), diff
    st = eng.stats
    for name, stat in zip(JAX_COUNTERS, PORT_STATS):
        assert st[stat] == c1[name] - c0[name], (stat, st[stat])
    assert st["spec_dispatches"] > 0 and st["spec_draft_tokens"] > 0
    assert st["spec_tokens"] > st["spec_dispatches"]   # > 1 a dispatch
    if kv is None and kind != "ngram":
        # the true continuation (oracle, self-drafting): all kept
        assert st["spec_accepted_tokens"] == st["spec_draft_tokens"]
    assert np.all(eng.blocks.refcount[1:] == 0)
    if kind == "draft_model":
        assert eng._spec._eng._spec is None
        assert eng._spec._eng.stats["ragged_steps"] > 0


def test_budget_and_eos_honoured_mid_bundle(pair, refs24):
    tm = pair[1]
    refs = [list(r) for r in refs24]
    # max_new 3 with spec_k 4: a full bundle must not overshoot
    _, out3 = _run(tm, _prompts()[:2], 3, spec_decode=OracleDrafter(refs))
    for a, b, p in zip(_ref(refs24, 3, 2), out3, _prompts()[:2]):
        np.testing.assert_array_equal(a, b)
        assert len(b) == len(p) + 3
    prompts = _prompts()[:2]
    eos = int(refs24[0][len(prompts[0]) + 2])

    def truncate(p, r):
        gen = list(r[len(p):])
        cut = gen.index(eos) + 1 if eos in gen else len(gen)
        return np.concatenate([p, np.asarray(gen[:cut], r.dtype)])

    eng, out = _run(tm, prompts, 24, eos=eos,
                    spec_decode=OracleDrafter(refs))
    for p, r, o in zip(prompts, refs24, out):
        np.testing.assert_array_equal(o, truncate(p, r))
    assert eng.stats["spec_accepted_tokens"] > 0


def test_collapse_falls_back_to_the_plain_chunk(pair, refs24):
    """Every draft rejected: the EWMA collapses each slot into a cooldown,
    draft-free steps fall back (no_drafts), pages of rejected positions
    are trimmed, and no token changes."""
    tm = pair[1]
    refs = [list(r) for r in refs24]
    eng, out = _run(tm, _prompts(), 24, spec_decode=WrongDrafter(refs),
                    spec_cooldown=64)
    for a, b in zip(refs24, out):
        np.testing.assert_array_equal(a, b)
    st = eng.stats
    assert st["spec_accepted_tokens"] == 0 and st["spec_rollbacks"] > 0
    assert st["spec_fallbacks"].get("no_drafts", 0) > 0
    assert st["decode_chunks"] > 0
    assert np.all(eng.blocks.refcount[1:] == 0)
    # a drafter that raises costs speed, never serving
    class Broken(Drafter):
        def propose(self, live, k):
            raise RuntimeError("drafter down")

    eng, out = _run(tm, _prompts()[:2], 12, spec_decode=Broken())
    for a, b in zip(_ref(refs24, 12, 2), out):
        np.testing.assert_array_equal(a, b)
    assert eng.stats["spec_fallbacks"]["drafter_error"] > 0
    assert "drafter down" in str(eng.spec_last_error)
    # a sampling pool is greedy-only's fallback
    eng = GenerationEngine(tm, spec_decode="ngram", seed=0, **KW)
    eng.add_request(_prompts()[2], max_new_tokens=6, temperature=0.7)
    with torch.inference_mode():
        eng.run()
    assert eng.stats["spec_fallbacks"]["sampling"] > 0


def test_chunked_prefill_interleave(pair):
    """A long prompt admitted mid-decode chunks through the ragged program
    while the running slots commit spec bundles; tokens equal the JAX
    engine's spec-off run of the same schedule."""
    jm, tm = pair
    long_prompt = np.random.RandomState(7).randint(1, 128, size=40)
    kw = dict(max_slots=3, page_size=4, max_seq_len=96, prefill_chunk=8,
              mixed_step=False)

    def drive(eng, jax=False):
        r1 = eng.add_request(np.tile(np.array([5, 6, 7, 8]), 4), 24)
        r2 = eng.add_request(np.array([9, 8, 7]), 24)
        with torch.inference_mode():
            while not (eng._reqs[r1].out and eng._reqs[r2].out):
                eng.step()
            r3 = eng.add_request(long_prompt, 12)     # 5 chunks of 8
            out = eng.run()
        return [out[r] for r in (r1, r2, r3)]

    ref = drive(JaxEngine(jm, **kw), jax=True)
    eng = GenerationEngine(tm, spec_decode=OracleDrafter(
        [list(r) for r in ref]), **kw)
    for a, b in zip(ref, drive(eng)):
        np.testing.assert_array_equal(a, b)
    assert eng.stats["ragged_steps"] >= 5
    assert eng.stats["spec_accepted_tokens"] > 0


def test_preempt_requeue_mid_spec(pair):
    """3 slots of 6-token prompts + 8 new over 8 usable pages of 4:
    preemptions while bundles commit; tokens equal the JAX engine's on a
    full pool and every page comes back."""
    jm, tm = pair
    prompts = [np.arange(1, 7), np.arange(10, 16), np.arange(20, 26)]
    kw = dict(max_slots=3, page_size=4, max_seq_len=32)
    ref = _drive(JaxEngine(jm, **kw), prompts, 8, jax=True)
    eng = GenerationEngine(tm, n_pages=9, spec_decode=OracleDrafter(
        [list(r) for r in ref]), **kw)
    for a, b in zip(ref, _drive(eng, prompts, 8)):
        np.testing.assert_array_equal(a, b)
    assert eng.stats["preemptions"] > 0
    assert eng.blocks.free_pages == 8


def test_env_flag_factory_and_refusals(pair, monkeypatch):
    tm = pair[1]
    kw = dict(max_slots=2, page_size=4, max_seq_len=64)
    monkeypatch.setenv("PADDLE_TPU_SPEC_DECODE", "ngram:2")
    eng = GenerationEngine(tm, **kw)
    assert isinstance(eng._spec, NgramDrafter) and eng._spec.ngram == 2
    assert GenerationEngine(tm, spec_decode=False, **kw)._spec is None
    # the draft model's engine stays spec-off under the flag
    dd = DraftModelDrafter(tm)
    GenerationEngine(tm, spec_decode=dd, **kw)
    assert dd._eng._spec is None and dd._eng.prefix_cache is False
    monkeypatch.setenv("PADDLE_TPU_SPEC_DECODE", "off")
    assert GenerationEngine(tm, **kw)._spec is None
    # an ambient typo serves plain and says why; an explicit one raises
    monkeypatch.setenv("PADDLE_TPU_SPEC_DECODE", "ngarm")
    eng = GenerationEngine(tm, **kw)
    assert eng._spec is None
    assert eng.spec_env_ignored == ("ngarm", "unknown_value")
    with pytest.raises(ValueError, match="unknown spec_decode"):
        GenerationEngine(tm, spec_decode="ngarm", **kw)

    class NoVerify:                     # the ragged contract, no verify
        def __init__(self, m):
            self.m = m
            self.device, self.dtype = m.device, m.dtype

        def __getattr__(self, name):
            if name == "paged_verify":
                raise AttributeError(name)
            return getattr(self.m, name)

    monkeypatch.setenv("PADDLE_TPU_SPEC_DECODE", "ngram")
    eng = GenerationEngine(NoVerify(tm), **kw)
    assert eng._spec is None
    assert eng.spec_env_ignored == ("ngram", "model_contract")
    with pytest.raises(ValueError, match="paged_verify"):
        GenerationEngine(NoVerify(tm), spec_decode="ngram", **kw)

    # the factory and the parser, against the JAX package's
    for v in ("", "0", "false", "off", "none", "no", "ngram", " NGRAM:4 ",
              None, "1"):
        assert spec_decode_from_env(v) == jspec.spec_decode_from_env(v)
    assert isinstance(make_drafter("1"), NgramDrafter)
    assert isinstance(make_drafter(True), NgramDrafter)
    assert make_drafter("ngram:5").ngram == 5
    d = NgramDrafter()
    assert make_drafter(d) is d
    with pytest.raises(ValueError):
        make_drafter("mystery")
    with pytest.raises(ValueError):
        NgramDrafter(ngram=2, min_gram=3)


def test_ngram_drafter_matches_jax():
    rng = np.random.default_rng(5)
    for trial in range(40):
        n = int(rng.integers(2, 60))
        toks = rng.integers(0, 6, n).astype(np.int32)   # repeats often
        gram, window, k = int(rng.integers(1, 5)), int(rng.integers(4, 80)), \
            int(rng.integers(1, 6))
        live = {0: toks, 3: toks[: max(2, n // 2)]}
        want = jspec.NgramDrafter(ngram=gram, max_window=window).propose(
            live, k)
        got = NgramDrafter(ngram=gram, max_window=window).propose(live, k)
        assert got == want, (trial, toks.tolist(), gram, window, k)
    d = NgramDrafter(ngram=3)
    toks = np.array([7, 1, 2, 3, 9, 9, 1, 2, 3], np.int32)
    assert d.propose({0: toks}, 4)[0] == [9, 9, 1, 2]
    assert NgramDrafter(ngram=3, max_window=4).propose({0: toks}, 4) == {}


def test_history_window_bounds_what_the_engine_copies(pair):
    seen = []

    class Probe(Drafter):
        history_window = 6

        def propose(self, live, k):
            seen.extend(int(np.asarray(v).size) for v in live.values())
            return {}

    eng = GenerationEngine(pair[1], max_slots=2, page_size=4,
                           max_seq_len=96, spec_decode=Probe())
    eng.add_request(np.arange(1, 31), max_new_tokens=6)   # 30-token prompt
    with torch.inference_mode():
        eng.run()
    assert seen and max(seen) <= 6


def _bm_state(bm):
    return (bm.block_tables.tolist(), bm.n_blocks.tolist(),
            bm.refcount.tolist(), sorted(bm._free), list(bm._cached),
            sorted((h, e[0], e[1], e[2]) for h, e in bm._index.items()),
            bm.cow_copies, bm.evictions)


def test_block_manager_trim_and_invalidate_match_jax():
    """One seeded random sequence of operations on both packages' block
    managers: after every operation the tables, block counts, refcounts,
    free list, cached LRU pool and index are equal, and so are the values
    trim returns and the errors an exhausted pool raises."""
    rng = np.random.default_rng(11)
    kw = dict(n_pages=9, page_size=4, pages_per_slot=8, max_slots=4,
              prefix_cache=True)
    jb, tb = JaxBlockManager(**kw), BlockManager(**kw)
    toks = {s: rng.integers(1, 50, 32) for s in range(4)}
    for step in range(400):
        op = rng.choice(["assign", "trim", "release", "fork", "register",
                         "match", "invalidate"],
                        p=[.34, .2, .08, .08, .14, .12, .04])
        s = int(rng.integers(0, 4))
        back, keep = int(rng.integers(0, 5)), int(rng.integers(0, 30))
        results = []
        for bm in (jb, tb):
            try:
                if op == "assign":
                    start = max(0, int(bm.n_blocks[s]) * 4 - back)
                    res = bm.assign(s, min(start, 28), 1 + step % 4)
                    res = (res[0].tolist(), res[1].tolist())
                elif op == "trim":
                    res = bm.trim(s, keep)
                elif op == "release":
                    res = bm.release(s)
                elif op == "fork":
                    d = (s + 1) % 4
                    bm.release(d)
                    res = bm.fork(s, d)
                elif op == "register":
                    res = bm.register_prefix(s, toks[s])
                elif op == "match":
                    pids, n = bm.match_prefix(toks[s], max_tokens=31)
                    for p in pids:           # unclaim what was claimed
                        bm.refcount[p] -= 1
                        if bm.refcount[p] == 0 and p in bm._hash_of:
                            bm._cached[p] = bm._hash_of[p]
                    res = (list(pids), n)
                else:
                    res = bm.invalidate_index()
                bm.drain_copies()
            except RuntimeError as e:
                res = ("error", "exhausted" in str(e))
            results.append(res)
        assert results[0] == results[1], (step, op, results)
        assert _bm_state(jb) == _bm_state(tb), (step, op)
    assert tb.evictions > 0 and tb.cow_copies > 0
