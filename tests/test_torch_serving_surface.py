"""The port engine's request lifecycle against the JAX engine's.

The tiny Llama (``LlamaConfig.tiny()``, seed 0) in both packages, weights
bridged with ``paddle_tpu_torch.weights``, float32, pages of 4; one
module-scoped JAX run of 16 new tokens over three prompts is the
reference.

- ``stream`` and ``astream`` yield what ``run()`` returns, from one
  thread and from two threads sharing the engine (more requests than
  slots), with speculative decoding too; ``run()`` beside a live stream
  returns only what no stream consumes;
- ``cancel_request`` frees every page of the request at once (before the
  next step), mid-decode and mid-prefill; ``cancel_by_trace`` reaches a
  queued request; a stream of a cancelled request raises
  ``RequestCancelledError``; a deadline carried by an imported snapshot
  raises ``DeadlineExceededError`` at the next step and frees the pages;
- ``export_request`` gives the JAX engine's snapshot for the same request
  state, clocks aside (plain Python values), also mid-spec (verified
  tokens only); a JAX snapshot imported into the port continues
  token-exact, and the reverse; ``stream_request(rid, start)`` resumes
  exactly once; ``remove_request`` evicts and frees;
- ``swap_weights`` mid-run (a real weight change, in place on a trainable
  parameter) clears the prefix index and the draft state, and the
  continuation equals the JAX engine's after the same swap;
- no module of the port imports ``jax`` or ``paddle_tpu`` (the new
  speculative module included).

Tolerance: exact token equality, and exact snapshot equality for every
key but the clocks (``age_s``, ``ttft_s``).
"""

import asyncio
import contextlib
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import speculative as jspec
from paddle_tpu.inference.engine import GenerationEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch import weights
from paddle_tpu_torch.inference import (DeadlineExceededError,
                                        DraftModelDrafter, Drafter,
                                        GenerationEngine,
                                        RequestCancelledError,
                                        make_sequence_snapshot)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(max_slots=2, page_size=4, max_seq_len=64, mixed_step=False)
N_NEW = 16
CLOCKS = ("age_s", "ttft_s")


def _models():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny())
    arrays = {n: np.asarray(p._value, np.float32)
              for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    weights.from_paddle_tpu_state(arrays, tm)
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _models()


def _prompts():
    return [np.array([1, 2, 3]), np.array([9, 8, 7, 6, 5, 4, 3]),
            np.tile(np.array([5, 6, 7, 8]), 3)]


@pytest.fixture(scope="module")
def ref(pair):
    """The JAX engine's results of N_NEW tokens over _prompts()."""
    eng = JaxEngine(pair[0], **KW)
    rids = [eng.add_request(p, max_new_tokens=N_NEW) for p in _prompts()]
    out = eng.run()
    return [out[r] for r in rids]


def _gen(ref, i):
    return ref[i][len(_prompts()[i]):].tolist()


class OracleDrafter(Drafter):
    """Proposes the true continuation: every draft verifies."""

    def __init__(self, refs):
        self.refs = [np.asarray(r) for r in refs]

    def propose(self, live, k):
        out = {}
        for slot, toks in live.items():
            for r in self.refs:
                n = len(toks)
                if n < r.size and np.array_equal(r[:n], toks):
                    if r[n:n + k].size:
                        out[slot] = [int(x) for x in r[n:n + k]]
                    break
        return out


def test_stream_and_astream_yield_what_run_returns(pair, ref):
    tm = pair[1]
    prompts = _prompts()
    eng = GenerationEngine(tm, **KW)
    assert list(eng.stream(prompts[0], N_NEW)) == _gen(ref, 0)

    # two threads on one engine, three requests over two slots
    got = {}

    def consume(idx):
        for i in idx:
            got[i] = list(eng.stream(prompts[i], N_NEW))

    threads = [threading.Thread(target=consume, args=(idx,))
               for idx in ([0, 2], [1])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert got == {i: _gen(ref, i) for i in range(3)}
    assert not eng.has_work() and not eng._streaming
    assert np.all(eng.blocks.refcount[1:] == 0)

    async def both():
        async def one(i):
            return [t async for t in eng.astream(prompts[i], N_NEW)]
        return await asyncio.gather(one(1), one(2))

    assert asyncio.run(both()) == [_gen(ref, 1), _gen(ref, 2)]

    # run() beside a live stream returns only what no stream consumes
    it = eng.stream(prompts[0], N_NEW)
    first = next(it)
    rid = eng.add_request(prompts[1], max_new_tokens=N_NEW)
    results = eng.run()
    assert list(results) == [rid]
    np.testing.assert_array_equal(results[rid], ref[1])
    assert [first] + list(it) == _gen(ref, 0)

    # token by token with speculative decoding (bundles of up to 5)
    spec = GenerationEngine(tm, spec_decode=OracleDrafter(ref), **KW)
    assert list(spec.stream(prompts[2], N_NEW)) == _gen(ref, 2)
    assert spec.stats["spec_accepted_tokens"] > 0


def test_cancel_frees_every_page_within_one_step(pair, ref):
    tm = pair[1]
    prompts = _prompts()
    eng = GenerationEngine(tm, **dict(KW, prefill_chunk=4))
    ra = eng.add_request(prompts[0], max_new_tokens=N_NEW)
    rb = eng.add_request(prompts[1], max_new_tokens=N_NEW,
                         trace_id="trace-b")
    rc = eng.add_request(prompts[2], max_new_tokens=N_NEW,
                         trace_id="trace-c", tenant="acme corp")
    with torch.inference_mode():
        eng.step()               # a admitted dense, b prefilling (chunk 4)
    slot_b = eng._reqs[rb].slot
    assert slot_b >= 0 and slot_b in eng._prefilling
    pages_b = [int(p) for p in
               eng.blocks.block_tables[slot_b, :eng.blocks.n_blocks[slot_b]]]
    assert pages_b
    free0 = eng.blocks.free_pages
    assert eng.cancel_request(rb, reason="abandoned")   # mid-prefill
    assert all(eng.blocks.refcount[p] == 0 for p in pages_b)
    assert eng.blocks.free_pages == free0 + len(pages_b)
    assert eng._slots[slot_b] is None and slot_b not in eng._prefilling
    assert not eng.cancel_request(rb)                   # idempotent
    assert eng._reqs[rc].tenant == "acme_corp"
    assert eng.find_rid_by_trace("trace-c") == rc
    assert eng.cancel_by_trace("trace-c")               # still queued
    assert not eng.cancel_by_trace("trace-x")
    with torch.inference_mode():
        while len(eng._reqs[ra].out) < 3:
            eng.step()
    assert eng.cancel_request(ra)                       # mid-decode
    assert np.all(eng.blocks.refcount[1:] == 0)
    assert eng.blocks.free_pages == eng.blocks.n_pages - 1
    assert eng.stats["cancels"] == 3
    done = eng.run()
    assert sorted(done) == [ra, rb, rc] and len(done[rb]) == len(prompts[1])

    # a stream of a cancelled request raises
    it = eng.stream(prompts[0], N_NEW)
    assert next(it) == _gen(ref, 0)[0]
    rid = max(eng._reqs)
    assert eng.cancel_request(rid)
    with pytest.raises(RequestCancelledError):
        list(it)


def test_imported_deadline_raises_and_frees(pair, ref):
    tm = pair[1]
    prompts = _prompts()
    eng = GenerationEngine(tm, **KW)
    # 10 s old with a 5 s budget: expired at the next step
    snap = make_sequence_snapshot(prompts[0], remaining=N_NEW, age_s=10.0,
                                  deadline_ms=5000.0)
    rid = eng.import_request(snap)
    with pytest.raises(DeadlineExceededError):
        list(eng.stream_request(rid))
    assert eng.stats["deadline_exceeded"] == 1
    assert np.all(eng.blocks.refcount[1:] == 0) and not eng.has_work()
    # expiry mid-decode: the budget runs out while the request decodes
    rid = eng.import_request(make_sequence_snapshot(
        prompts[1], remaining=N_NEW, deadline_ms=60_000.0))
    it = eng.stream_request(rid)
    assert next(it) == (0, _gen(ref, 1)[0])
    eng._reqs[rid].t_submit -= 120.0        # two minutes pass
    with pytest.raises(DeadlineExceededError):
        list(it)
    assert np.all(eng.blocks.refcount[1:] == 0)
    # a budget that holds changes nothing
    rid = eng.import_request(make_sequence_snapshot(
        prompts[2], remaining=N_NEW, deadline_ms=600_000.0))
    assert [t for _, t in eng.stream_request(rid)] == _gen(ref, 2)


def _jax_oracle(refs):
    d = type("JaxOracle", (jspec.Drafter,),
             {"propose": OracleDrafter.propose})()
    d.refs = [np.asarray(r) for r in refs]
    return d


def _plain(snap):
    """A snapshot's JSON-able primitives: every value a Python bool, int,
    float, str, None or list of ints."""
    for k, v in snap.items():
        if k == "tokens":
            assert all(type(t) is int for t in v), k
        else:
            assert v is None or type(v) in (bool, int, float, str), (k, v)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "mid_spec"])
def test_export_equals_jax_snapshot(pair, ref, spec):
    """Both engines hold the same request state after the same steps; the
    snapshots are equal but for the clocks. Mid-spec they carry the
    verified tokens only."""
    jm, tm = pair
    prompts = _prompts()
    kw = dict(KW)
    if spec:
        jeng = JaxEngine(jm, spec_decode=_jax_oracle(ref), **kw)
        teng = GenerationEngine(tm, spec_decode=OracleDrafter(ref), **kw)
    else:
        jeng, teng = JaxEngine(jm, **kw), GenerationEngine(tm, **kw)
    rids = []
    for i, p in enumerate(prompts):
        args = (p, N_NEW, 0.0, None, i % 2, None)
        rids.append((jeng.add_request(*args, trace_id=f"t{i}", tenant="a"),
                     teng.add_request(*args, trace_id=f"t{i}", tenant="a")))
    mid = 0
    while teng.has_work():
        for j, t in rids:
            if t not in teng._reqs:
                assert j not in jeng._reqs      # retired in both
                continue
            js, ts = jeng.export_request(j), teng.export_request(t)
            _plain(ts)
            assert {k: v for k, v in ts.items() if k not in CLOCKS} == \
                {k: v for k, v in js.items() if k not in CLOCKS}
            assert (ts["ttft_s"] is None) == (js["ttft_s"] is None)
            req = teng._reqs[t]
            assert ts["tokens"] == [int(x) for x in req.prompt] + req.out
            assert ts["remaining"] == N_NEW - len(req.out)
            mid += 0 < len(req.out) < N_NEW
        jeng.step()
        with torch.inference_mode():
            teng.step()
    assert mid >= 2 and not jeng.has_work()
    if spec:
        assert teng.stats["spec_accepted_tokens"] > 0


def test_snapshots_cross_packages_token_exact(pair, ref):
    """A JAX snapshot taken mid-decode continues in the port token-exact,
    and a port snapshot in the JAX engine; stream_request resumes at the
    cursor; remove_request evicts and frees."""
    jm, tm = pair
    prompts = _prompts()
    jeng = JaxEngine(jm, **KW)
    jr = [jeng.add_request(p, max_new_tokens=N_NEW) for p in prompts[:2]]
    while len(jeng._reqs[jr[0]].out) < 4:
        jeng.step()
    snaps = [jeng.remove_request(r) for r in jr]
    teng = GenerationEngine(tm, **KW)
    tr = [teng.import_request(s) for s in snaps]
    cursor = len(snaps[0]["tokens"]) - len(prompts[0])
    assert cursor >= 4
    pairs = list(teng.stream_request(tr[0], start=cursor))
    assert [n for n, _ in pairs] == list(range(cursor, N_NEW))
    assert [t for _, t in pairs] == _gen(ref, 0)[cursor:]
    out = teng.run()
    np.testing.assert_array_equal(out[tr[1]], ref[1])

    # the reverse: port mid-decode -> JAX
    teng = GenerationEngine(tm, **KW)
    rid = teng.add_request(prompts[2], max_new_tokens=N_NEW, trace_id="z")
    with torch.inference_mode():
        while len(teng._reqs[rid].out) < 5:
            teng.step()
    assert teng.find_rid_by_trace("z") == rid
    snap = teng.remove_request(rid)
    assert rid not in teng._reqs and not teng.has_work()
    assert np.all(teng.blocks.refcount[1:] == 0)
    with pytest.raises(KeyError):
        teng.export_request(rid)
    jeng = JaxEngine(jm, **KW)
    jr = jeng.import_request(snap)
    assert jeng._reqs[jr].trace == "z"
    np.testing.assert_array_equal(jeng.run()[jr], ref[2])
    # a finished snapshot is resident for replay only
    done = make_sequence_snapshot(ref[2], prompt0=len(prompts[2]))
    rid = teng.import_request(done)
    assert [t for _, t in teng.stream_request(rid, start=N_NEW - 2)] == \
        _gen(ref, 2)[-2:]


def test_swap_weights_mid_run_matches_jax(pair):
    """A prefix is indexed and a self-drafting run is mid-spec when both
    engines swap in the same weight change; the swap clears the prefix
    index and the draft state, the in-flight sequences continue under the
    new weights as the JAX engine's do, and KV begun under the old
    weights is never indexed."""
    jm, tm = _models()                       # this test changes weights
    prompts = _prompts()
    kw = dict(KW, max_slots=2)
    scale = np.float32(3.0)
    name = "llama.layers.0.self_attn.o_proj.weight"
    tw = dict(tm.named_parameters())[name]
    w = dict(jm.named_parameters())[name]
    unswapped = _drive_plain(tm, prompts[:2], kw)

    def drive(eng, jax):
        ctx = contextlib.nullcontext() if jax else torch.inference_mode()
        first = eng.add_request(prompts[2], max_new_tokens=4)
        with ctx:
            eng.run()                        # retires: its pages indexed
            assert len(eng.blocks._index) > 0
            rids = [eng.add_request(p, max_new_tokens=N_NEW)
                    for p in prompts[:2]]
            while not all(len(eng._reqs[r].out) >= 2 for r in rids):
                eng.step()
        return first, rids

    jd = jspec.DraftModelDrafter(jm)
    jeng = JaxEngine(jm, spec_decode=jd, **kw)
    _, jr = drive(jeng, True)
    jeng.swap_weights(lambda: w.set_value(np.asarray(w._value) * scale),
                      tag="b")
    jout = jeng.run()

    td = DraftModelDrafter(tm)
    teng = GenerationEngine(tm, spec_decode=td, **kw)
    _, tr = drive(teng, False)
    assert td._hist and teng._spec_state            # mid-spec state
    # the loader changes a trainable leaf in place: it runs under no_grad
    assert tw.requires_grad
    teng.swap_weights(lambda: tw.mul_(float(scale)), tag="b")
    assert not teng.blocks._index and not teng.blocks._cached
    assert not td._hist and not td._ctx and not teng._spec_state
    assert teng._weight_epoch == 1 and teng._weights_tag == "b"
    with torch.inference_mode():
        tout = teng.run()
    for j, t in zip(jr, tr):
        np.testing.assert_array_equal(tout[t], jout[j])
    assert any(not np.array_equal(tout[t], u)     # the swap took effect
               for t, u in zip(tr, unswapped))
    assert not teng.blocks._index       # old-epoch KV is never indexed
    assert teng.stats["spec_accepted_tokens"] > 0


def _drive_plain(tm, prompts, kw):
    eng = GenerationEngine(tm, **kw)
    rids = [eng.add_request(p, max_new_tokens=N_NEW) for p in prompts]
    with torch.inference_mode():
        out = eng.run()
    return [out[r] for r in rids]


def test_the_lifecycle_modules_import_neither_jax_nor_paddle_tpu():
    code = ("import sys, paddle_tpu_torch.inference.engine, "
            "paddle_tpu_torch.inference.speculative; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    for name in ("engine.py", "speculative.py"):
        text = (ROOT / "paddle_tpu_torch" / "inference" / name).read_text()
        assert "import jax" not in text and "from jax" not in text
        assert "from paddle_tpu." not in text and \
            "import paddle_tpu\n" not in text
