"""The port's GenerationEngine against the JAX package's, and the port's
isolation rules.

- greedy ``generate_batch`` on the JAX engine and the port's engine, both
  with the prefix cache, chunked prefill (chunk 8) and mixed steps, more
  requests than slots and two prompts sharing a page-aligned prefix: the
  tokens must be exactly equal, and the port must have served a prefix
  hit. One workload has every prompt longer than the chunk (all ragged);
  another mixes cold prompts no longer than the chunk, which both engines
  admit through the dense prefill, with long and prefix-sharing ones (the
  ragged path), at chunk 8 and with ``prefill_chunk=None``;
- the pages a dense admission writes equal the JAX engine's pools, and
  dense admissions that find the pool exhausted are requeued (tokens
  unchanged), or raise when nothing running could free pages;
- ``fork_request`` mid-decode: the fork's first write into the shared
  partial tail page is a real copy-on-write, and both the parent and the
  fork end with the JAX engine's tokens;
- int8 KV pages (``kv_dtype="int8"``): greedy tokens equal the JAX int8
  engine's, run as the TPU program runs it (``_dense_fallback = False`` on
  the JAX instance: off the TPU the JAX engine otherwise decodes a chunk
  densely and quantizes its new rows only at the chunk's end), and differ
  from the float engine's somewhere; one dense admission writes the JAX
  engine's codes and scale rows; a fork's CoW copy carries the scale rows;
  the ``kv_dtype`` argument and the ``PADDLE_TPU_KV_INT8`` flag;
- ``BlockManager`` unit cases, the ones ``tests/test_serving_fastpath.py``
  runs against the JAX package's copy, pointed at the port's copy;
- entry points (the models, and every layer that holds parameters)
  raise without ``device="cpu"`` when no CUDA card is present; ``import paddle_tpu_torch`` pulls in neither ``jax`` nor
  ``paddle_tpu``, and no module of the port (nor ``chip_smoke.py``) has
  an import of either.

Tolerance: exact token equality. Both engines run the same float32
arithmetic up to summation order (logit differences ~1e-6), far inside
the tiny model's greedy margins on these prompts.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch import weights
from paddle_tpu_torch.inference.engine import BlockManager, GenerationEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINE_KW = dict(max_slots=2, page_size=4, max_seq_len=64, prefix_cache=True,
                 prefill_chunk=8, mixed_step=True)


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
    rng = np.random.default_rng(1)
    shared = rng.integers(1, 128, 12)          # 3 full pages of 4
    prompts = [np.concatenate([shared, rng.integers(1, 128, 5)]),
               rng.integers(1, 128, 11), rng.integers(1, 128, 14),
               np.concatenate([shared, rng.integers(1, 128, 3)]),
               rng.integers(1, 128, 9)]
    return [p.astype(np.int32) for p in prompts]


def test_generate_batch_greedy_parity_with_jax_engine(pair):
    jm, tm = pair
    prompts = _prompts()
    want = jm.generate_batch(prompts, max_new_tokens=10, **ENGINE_KW)
    eng = GenerationEngine(tm, **ENGINE_KW)
    rids = [eng.add_request(p, max_new_tokens=10) for p in prompts]
    with torch.inference_mode():
        out = eng.run()
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(out[rid], w)
    assert eng.stats["prefix_hits"] >= 1
    assert eng.stats["prefix_hit_tokens"] == 12
    assert eng.stats["mixed_decode_tokens"] > 0    # decode rode a chunk
    # every page is back: refcount-0, free or parked in the cached pool
    assert np.all(eng.blocks.refcount[1:] == 0)
    # the model's front door gives the same tokens
    got = tm.generate_batch(prompts, max_new_tokens=10, **ENGINE_KW)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _mixed_prompts():
    """Cold prompts no longer than the chunk of 8 (dense admission) mixed
    with a long cold prompt and two sharing an 8-token (2-page) prefix, the
    second of which arrives after the first is indexed (ragged suffix)."""
    rng = np.random.default_rng(2)
    shared = rng.integers(1, 128, 8)
    prompts = [np.concatenate([shared, rng.integers(1, 128, 2)]),
               rng.integers(1, 128, 5), rng.integers(1, 128, 8),
               np.concatenate([shared, rng.integers(1, 128, 3)]),
               rng.integers(1, 128, 13), rng.integers(1, 128, 3)]
    return [p.astype(np.int32) for p in prompts]


@pytest.mark.parametrize("chunk", [8, None], ids=["chunk8", "no_chunk"])
def test_dense_admission_greedy_parity_with_jax_engine(pair, chunk):
    """Cold prompts that fit the chunk go through the dense prefill in both
    engines (with prefill_chunk=None every cold prompt does); long and
    prefix-hit prompts through the ragged program. Tokens are equal."""
    jm, tm = pair
    kw = dict(ENGINE_KW, prefill_chunk=chunk)
    prompts = _mixed_prompts()
    want = jm.generate_batch(prompts, max_new_tokens=10, **kw)
    eng = GenerationEngine(tm, **kw)
    rids = [eng.add_request(p, max_new_tokens=10) for p in prompts]
    with torch.inference_mode():
        out = eng.run()
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(out[rid], w)
    st = eng.stats
    assert st["prefill_admits"] > 0
    assert st["prefill_tokens"] == sum(
        len(p) for p in prompts
        if chunk is None or len(p) <= chunk) - (11 if chunk is None else 0)
    assert st["prefix_hits"] == 1 and st["prefix_hit_tokens"] == 8
    assert st["ragged_steps"] > 0          # the suffix (and long) prompts
    assert np.all(eng.blocks.refcount[1:] == 0)


def test_dense_admission_writes_the_jax_engines_pages(pair):
    """One dense admission of three cold prompts (and a dummy row, c = 4):
    the pages it writes, and every other page, equal the JAX engine's
    pools after the same admission."""
    from paddle_tpu.inference.engine import GenerationEngine as JaxEngine
    jm, tm = pair
    kw = dict(ENGINE_KW, max_slots=3)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 128, n).astype(np.int32) for n in (7, 3, 8)]
    jeng = JaxEngine(jm, **kw)
    teng = GenerationEngine(tm, **kw)
    for p in prompts:
        jeng.add_request(p, max_new_tokens=1)
        teng.add_request(p, max_new_tokens=1)
    jeng.run()
    with torch.inference_mode():
        teng.run()
    assert teng.stats["prefill_admits"] == 1
    assert teng.stats["ragged_steps"] == teng.stats["decode_chunks"] == 0
    for jp, tp in zip(jeng.k_pages + jeng.v_pages,
                      teng.k_pages + teng.v_pages):
        # page 0 is the trash page: padding lands there in both
        np.testing.assert_allclose(tp.numpy()[1:], np.asarray(jp)[1:],
                                   atol=1e-4)
    assert float(teng.k_pages[0][1:6].abs().sum()) > 0   # 5 pages written


def test_dense_admission_requeues_on_an_exhausted_pool(pair):
    """Three usable pages: of two 7-token cold prompts admitted together,
    the second finds no pages and is requeued at the front, then served
    once the first retires. Tokens equal the JAX engine's on a full pool.
    A prompt that alone exceeds the pool raises."""
    jm, tm = pair
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 128, 7).astype(np.int32) for _ in range(2)]
    want = jm.generate_batch(prompts, max_new_tokens=5, **ENGINE_KW)
    eng = GenerationEngine(tm, n_pages=4, **ENGINE_KW)
    rids = [eng.add_request(p, max_new_tokens=5) for p in prompts]
    with torch.inference_mode():
        out = eng.run()
    assert eng.stats["requeues"] >= 1
    assert eng.stats["prefill_admits"] == 2
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(out[rid], w)

    alone = GenerationEngine(tm, n_pages=2, **ENGINE_KW)   # one page
    alone.add_request(prompts[0], max_new_tokens=1)
    with torch.inference_mode(), pytest.raises(RuntimeError,
                                               match="exhausted"):
        alone.run()


def test_fork_request_copies_on_write_and_matches_jax(pair):
    jm, tm = pair
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    ref = jm.generate_batch([prompt], max_new_tokens=12, **ENGINE_KW)[0]
    eng = GenerationEngine(tm, **ENGINE_KW)
    rid = eng.add_request(prompt, max_new_tokens=12)
    with torch.inference_mode():
        while len(eng._reqs[rid].out) < 4:     # mid-decode, tail partial
            eng.step()
        cow0 = eng.blocks.cow_copies
        child = eng.fork_request(rid)
        results = eng.run()
    assert eng.blocks.cow_copies > cow0        # the tail page diverged
    assert eng.stats["cow_flushes"] > 0
    np.testing.assert_array_equal(results[rid], ref)
    np.testing.assert_array_equal(results[child], ref)


def test_preemption_under_a_small_pool_keeps_tokens(pair):
    """An oversubscribed pool preempts recompute-style and re-admits; the
    tokens still equal the JAX engine's on a full pool."""
    jm, tm = pair
    prompts = _prompts()[:3]
    want = jm.generate_batch(prompts, max_new_tokens=10, **ENGINE_KW)
    eng = GenerationEngine(tm, n_pages=9, **ENGINE_KW)
    rids = [eng.add_request(p, max_new_tokens=10) for p in prompts]
    with torch.inference_mode():
        out = eng.run()
    assert eng.stats["preemptions"] > 0
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(out[rid], w)


@pytest.mark.parametrize("kw", [dict(kv_dtype="int4"), dict(spec_decode="ngarm"),
                                dict(prefix_store=object()),
                                dict(with_kv=True)])
def test_options_of_later_slices_raise(pair, kw):
    """A kv_dtype other than None or "int8" and an unknown spec_decode
    value are refused as the JAX engine refuses them. The options that
    later slices brought are served now: a prefix store wires the
    eviction spill hook, and ``export_request(with_kv=True)`` of a request
    with no written page gives the plain snapshot (no ``kv``), as the JAX
    engine's does."""
    if "kv_dtype" in kw or "spec_decode" in kw:
        with pytest.raises(ValueError, match="kv_dtype|spec_decode"):
            GenerationEngine(pair[1], **kw)
        return
    if "with_kv" in kw:
        from paddle_tpu.inference.engine import GenerationEngine as JaxEngine
        snaps = []
        for eng in (GenerationEngine(pair[1], **ENGINE_KW),
                    JaxEngine(pair[0], **ENGINE_KW)):
            rid = eng.add_request([1, 2, 3], max_new_tokens=2)
            snaps.append(eng.export_request(rid, **kw))
        for snap in snaps:
            snap.pop("age_s")
            snap.pop("trace")
        assert "kv" not in snaps[0] and snaps[0] == snaps[1]
        return
    eng = GenerationEngine(pair[1], **ENGINE_KW, **kw)
    assert eng.prefix_store is kw["prefix_store"]
    assert eng.blocks.on_evict == eng._spill_page


# ----------------------------------------------------------------------
# int8 KV pages
# ----------------------------------------------------------------------

def _jax_int8_engine(jm, **kw):
    """The JAX int8 engine as the TPU runs it: every decode step quantizes
    its row through write_rows (the instance's dense CPU fallback off)."""
    from paddle_tpu.inference.engine import GenerationEngine as JaxEngine
    eng = JaxEngine(jm, kv_dtype="int8", **kw)
    eng._dense_fallback = False
    return eng


def _serve(eng, prompts, n_new, jax=False):
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    if jax:
        out = eng.run()
    else:
        with torch.inference_mode():
            out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("chunk", [8, None], ids=["chunk8", "no_chunk"])
def test_int8_greedy_parity_with_jax_int8_engine(pair, chunk):
    """The mixed workload (dense admissions, chunked and suffix ragged
    prefill after a prefix hit, mixed steps, decode chunks) over int8
    pools: tokens equal the JAX int8 engine's exactly, and differ from the
    port's float engine somewhere (the quantization is not a no-op)."""
    jm, tm = pair
    kw = dict(ENGINE_KW, prefill_chunk=chunk)
    prompts = _mixed_prompts()
    want = _serve(_jax_int8_engine(jm, **kw), prompts, 10, jax=True)
    eng = GenerationEngine(tm, kv_dtype="int8", **kw)
    got = _serve(eng, prompts, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    flt = _serve(GenerationEngine(tm, **kw), prompts, 10)
    assert any(not np.array_equal(g, f) for g, f in zip(got, flt))
    st = eng.stats
    assert st["prefill_admits"] > 0 and st["ragged_steps"] > 0
    assert st["prefix_hits"] == 1 and st["decode_chunks"] > 0
    assert eng.k_pages[0].dtype == torch.int8
    assert np.all(eng.blocks.refcount[1:] == 0)


def test_int8_dense_admission_writes_the_jax_engines_pages(pair):
    """One dense admission of three cold prompts (and a dummy row): the
    codes and scale rows it writes equal the JAX int8 engine's. A page's
    absmax covers the pad-token rows up to S_pad, as the JAX program's.
    Codes may differ by 1 where a value lies within float32 rounding of a
    half-code boundary (at most 1 in 500); scales rtol 1e-6."""
    jm, tm = pair
    kw = dict(ENGINE_KW, max_slots=3)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 128, n).astype(np.int32) for n in (7, 3, 8)]
    jeng = _jax_int8_engine(jm, **kw)
    teng = GenerationEngine(tm, kv_dtype="int8", **kw)
    _serve(jeng, prompts, 1, jax=True)
    _serve(teng, prompts, 1)
    assert teng.stats["prefill_admits"] == 1
    assert teng.stats["ragged_steps"] == teng.stats["decode_chunks"] == 0
    for jp, tp in zip(jeng.k_pages + jeng.v_pages,
                      teng.k_pages + teng.v_pages):
        assert tp.dtype == torch.int8
        diff = tp.numpy()[1:].astype(np.int32) - np.asarray(jp)[1:]
        assert np.abs(diff).max() <= 1       # a half-code boundary at most
        assert np.count_nonzero(diff) * 500 <= diff.size
    for js, ts in zip(jeng.k_scales + jeng.v_scales,
                      teng.k_scales + teng.v_scales):
        np.testing.assert_allclose(ts.numpy()[1:], np.asarray(js)[1:],
                                   rtol=1e-6)
        assert np.all(ts.numpy()[6:] == 1.0)     # unwritten pages: ones
    # the 7-token prompt's second page (page 2) holds positions 4..7 of
    # the (4, 8) bucket; position 7 is pad token 0's K/V, and in layer 1
    # it is the page's absmax: the frozen scale counts it
    ids = np.zeros((4, 8), np.int64)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    with torch.inference_mode():
        _, ks, vs = tm.paged_prefill(torch.from_numpy(ids),
                                     torch.tensor([7, 3, 8, 1]))
    for kv, scales in ((ks, teng.k_scales), (vs, teng.v_scales)):
        with_pad = float(kv[1, 0, 4:8].abs().max())
        assert float(scales[1][2]) == np.float32(with_pad)
        assert with_pad != float(kv[1, 0, 4:7].abs().max())


def test_int8_fork_copies_scale_rows_on_write(pair):
    """fork_request mid-decode over int8 pools: the fork's first write into
    the shared partial tail page copies the page WITH its frozen scale, and
    the parent and the fork both end with the JAX int8 engine's tokens."""
    jm, tm = pair
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    ref = _serve(_jax_int8_engine(jm, **ENGINE_KW), [prompt], 12,
                 jax=True)[0]
    eng = GenerationEngine(tm, kv_dtype="int8", **ENGINE_KW)
    flush = eng._flush_cow
    copied = []

    def checked_flush():
        pending = list(eng.blocks._pending_copies)
        flush()
        for src, dst in pending:
            copied.append(all(
                float(sc[dst]) == float(sc[src])
                for sc in eng.k_scales + eng.v_scales) and all(
                torch.equal(pool[dst], pool[src])
                for pool in eng.k_pages + eng.v_pages))

    eng._flush_cow = checked_flush
    rid = eng.add_request(prompt, max_new_tokens=12)
    with torch.inference_mode():
        while len(eng._reqs[rid].out) < 4:     # mid-decode, tail partial
            eng.step()
        child = eng.fork_request(rid)
        results = eng.run()
    assert copied and all(copied)
    np.testing.assert_array_equal(results[rid], ref)
    np.testing.assert_array_equal(results[child], ref)


def test_int8_kv_dtype_flag_and_pools(pair, monkeypatch):
    """The cases of tests/test_kv_int8.py's flag tests on the port's
    engine: explicit kv_dtype, the PADDLE_TPU_KV_INT8 flag (an explicit
    kv_dtype beats it), int8 pools with float32 scale rows of ones, and
    pool bytes (scale rows included) under half the float32 pools'."""
    tm = pair[1]
    monkeypatch.delenv("PADDLE_TPU_KV_INT8", raising=False)
    off = GenerationEngine(tm, **ENGINE_KW)
    assert off.kv_dtype is None and off.k_scales is None
    assert off.k_pages[0].dtype == torch.float32
    on = GenerationEngine(tm, kv_dtype="int8", **ENGINE_KW)
    assert on.kv_dtype == "int8" and on.k_pages[0].dtype == torch.int8
    assert len(on.k_scales) == len(on.v_scales) == len(on.k_pages)
    assert on.k_scales[0].shape == (on.blocks.n_pages,)
    assert on.k_scales[0].dtype == torch.float32
    assert bool((on.v_scales[1] == 1.0).all())
    assert 0 < on.stats["kv_pool_bytes"] < 0.5 * off.stats["kv_pool_bytes"]
    monkeypatch.setenv("PADDLE_TPU_KV_INT8", "1")
    assert GenerationEngine(tm, **ENGINE_KW).kv_dtype == "int8"
    monkeypatch.setenv("PADDLE_TPU_KV_INT8", "0")
    assert GenerationEngine(tm, **ENGINE_KW).kv_dtype is None
    assert GenerationEngine(tm, kv_dtype="int8",
                            **ENGINE_KW).kv_dtype == "int8"


# ----------------------------------------------------------------------
# BlockManager: the cases of tests/test_serving_fastpath.py, on the
# port's copy
# ----------------------------------------------------------------------

def _bm(n_pages=16, page=4, prefix_cache=True):
    return BlockManager(n_pages, page, pages_per_slot=8, max_slots=4,
                        prefix_cache=prefix_cache)


def test_fork_shares_pages_and_first_write_cows():
    bm = _bm()
    bm.assign(0, 0, 10)                 # 3 pages, last one partial (2/4)
    pages = [int(p) for p in bm.block_tables[0, :3]]
    bm.fork(0, 1)
    assert [int(p) for p in bm.block_tables[1, :3]] == pages
    assert all(bm.refcount[p] == 2 for p in pages)

    bm.assign(1, 10, 1)                 # fork writes into the tail page
    assert bm.cow_copies == 1
    copies = bm.drain_copies()
    new_tail = int(bm.block_tables[1, 2])
    assert copies == [(pages[2], new_tail)] and new_tail != pages[2]
    assert bm.refcount[pages[2]] == 1 and bm.refcount[new_tail] == 1
    assert all(bm.refcount[p] == 2 for p in pages[:2])

    bm.assign(0, 10, 1)                 # src's tail is private now: no CoW
    assert bm.cow_copies == 1 and bm.drain_copies() == []


def test_cow_sweep_covers_every_shared_page_in_write_range():
    bm = _bm(n_pages=32)
    bm.assign(0, 0, 8)                  # two FULL pages
    bm.fork(0, 1)
    bm.assign(1, 4, 8)                  # overwrite page 1, grow page 2
    assert bm.cow_copies == 1
    assert len(bm.drain_copies()) == 1
    assert int(bm.block_tables[0, 1]) != int(bm.block_tables[1, 1])


def test_partial_page_boundary_never_indexed_or_matched():
    bm = _bm()
    toks = np.arange(100, 110)          # 10 tokens -> 2 full + 1 partial
    bm.assign(0, 0, 10)
    bm.register_prefix(0, toks)
    assert len(bm._index) == 2
    assert int(bm.block_tables[0, 2]) not in bm._hash_of

    pids, n = bm.match_prefix(toks)
    assert n == 8 and len(pids) == 2
    for p in pids:
        bm.refcount[p] -= 1

    bm2 = _bm()
    aligned = np.arange(200, 208)       # exactly 2 pages
    bm2.assign(0, 0, 8)
    bm2.register_prefix(0, aligned)
    pids, n = bm2.match_prefix(aligned, max_tokens=len(aligned) - 1)
    assert n == 4 and len(pids) == 1

    fork = toks.copy()
    fork[5] = 999                       # inside page 1
    pids, n = bm.match_prefix(fork)
    assert n == 4 and len(pids) == 1


def test_release_parks_indexed_pages_and_lru_evicts():
    bm = _bm(n_pages=8)                 # 7 usable pages
    toks = np.arange(1, 9)
    bm.assign(0, 0, 8)
    bm.register_prefix(0, toks)
    assert bm.free_pages == 5
    bm.release(0)
    assert bm.free_pages == 7
    assert len(bm._cached) == 2

    pids, n = bm.match_prefix(toks, max_tokens=7)
    assert n == 4
    assert not any(p in bm._cached for p in pids)
    for p in pids:
        bm.refcount[p] -= 1
        bm._cached[p] = bm._hash_of[p]

    ev0 = bm.evictions
    for i in range(5):
        bm.assign(1, i * 4, 1)
    assert bm.evictions == ev0
    bm.assign(1, 20, 1)
    assert bm.evictions == ev0 + 1
    assert len(bm._index) == 1

    bm3 = _bm(n_pages=3, prefix_cache=False)
    bm3.assign(0, 0, 8)
    with pytest.raises(RuntimeError, match="exhausted"):
        bm3.assign(1, 0, 1)
    bm3.release(0)
    assert sorted(bm3._free) == [1, 2]


def test_write_into_owned_indexed_page_unregisters_it():
    bm = _bm()
    toks = np.arange(50, 58)
    bm.assign(0, 0, 8)
    bm.register_prefix(0, toks)
    assert len(bm._index) == 2
    bm.assign(0, 4, 1)                  # rewrite inside page 1 (owned)
    assert len(bm._index) == 1
    assert int(bm.block_tables[0, 1]) not in bm._hash_of
    assert bm.cow_copies == 0


# ----------------------------------------------------------------------
# device resolution and isolation from JAX
# ----------------------------------------------------------------------

def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    from paddle_tpu_torch import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny(), device="cuda")
    assert LlamaForCausalLM(LlamaConfig.tiny(),
                            device="cpu").device.type == "cpu"
    # every layer and model that holds parameters resolves its device so
    from paddle_tpu_torch import audio
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.incubate import nn as tinn
    from paddle_tpu_torch.incubate.distributed.models import moe
    from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                         BertForSequenceClassification,
                                         BertModel, GPTConfig,
                                         GPTForCausalLM)
    makers = [
        lambda **kw: tnn.Linear(4, 8, **kw),
        lambda **kw: tnn.Embedding(6, 4, **kw),
        lambda **kw: tnn.RMSNorm(8, **kw),
        lambda **kw: tnn.RMSNorm(8, weight_attr=False, **kw),
        lambda **kw: tnn.LayerNorm(8, **kw),
        lambda **kw: tnn.MultiHeadAttention(8, 2, **kw),
        lambda **kw: tnn.TransformerEncoderLayer(8, 2, 16, **kw),
        lambda **kw: tnn.TransformerDecoderLayer(8, 2, 16, **kw),
        lambda **kw: tnn.Transformer(8, 2, 1, 1, 16, **kw),
        lambda **kw: tinn.FusedBiasDropoutResidualLayerNorm(8, **kw),
        lambda **kw: tinn.FusedLinear(4, 8, **kw),
        lambda **kw: tinn.FusedMultiHeadAttention(8, 2, **kw),
        lambda **kw: tinn.FusedFeedForward(8, 16, **kw),
        lambda **kw: tinn.FusedTransformerEncoderLayer(8, 2, 16, **kw),
        lambda **kw: tinn.FusedMultiTransformer(8, 2, 16, **kw),
        lambda **kw: GPTForCausalLM(GPTConfig.tiny(), **kw),
        lambda **kw: BertModel(BertConfig.tiny(), **kw),
        lambda **kw: BertForMaskedLM(BertConfig.tiny(), **kw),
        lambda **kw: BertForSequenceClassification(BertConfig.tiny(),
                                                   **kw),
        lambda **kw: LlamaForCausalLM(
            LlamaConfig(**{**vars(LlamaConfig.tiny()), "recompute": True}),
            **kw),
        lambda **kw: moe.MoELayer(8, 16, num_expert=4, **kw),
        lambda **kw: moe.GShardGate(8, 4, **kw),
        lambda **kw: moe.SwitchGate(8, 4, **kw),
        lambda **kw: audio.MFCC(sr=8000, **kw),
    ]
    for make in makers:
        for kw in ({}, {"device": "cuda"}):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(**kw)
        assert all(p.device.type == "cpu"
                   for p in make(device="cpu").parameters())


def test_import_pulls_in_neither_jax_nor_paddle_tpu():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.models, "
            "paddle_tpu_torch.inference, paddle_tpu_torch.weights, "
            "paddle_tpu_torch.ops.kernels, paddle_tpu_torch.models.gpt, "
            "paddle_tpu_torch.models.bert, paddle_tpu_torch.nn.transformer, "
            "paddle_tpu_torch.incubate.nn, paddle_tpu_torch.amp, "
            "paddle_tpu_torch.amp.lists, paddle_tpu_torch.optimizer, "
            "paddle_tpu_torch.optimizer.lr, paddle_tpu_torch.optimizer.extra, "
            "paddle_tpu_torch.jit, paddle_tpu_torch.distributed, "
            "paddle_tpu_torch.distributed.checkpoint, "
            "paddle_tpu_torch.distributed.fleet.utils.recompute, "
            "paddle_tpu_torch.observability.perf, "
            "paddle_tpu_torch.observability.xla_introspect, "
            "paddle_tpu_torch.io, paddle_tpu_torch.io._shm_worker, "
            "paddle_tpu_torch.profiler, paddle_tpu_torch.amp.debugging, "
            "paddle_tpu_torch.framework.flags, "
            "paddle_tpu_torch.distributed.watchdog, "
            "paddle_tpu_torch.distributed.fleet.elastic, "
            "paddle_tpu_torch.distributed.resilient, "
            "paddle_tpu_torch.distributed.parallel_base, "
            "paddle_tpu_torch.distributed.communication, "
            "paddle_tpu_torch.distributed.communication.stream, "
            "paddle_tpu_torch.distributed.auto_parallel, "
            "paddle_tpu_torch.distributed.auto_parallel.api, "
            "paddle_tpu_torch.distributed.auto_parallel.placement, "
            "paddle_tpu_torch.distributed.auto_parallel.process_mesh, "
            "paddle_tpu_torch.distributed.fleet, "
            "paddle_tpu_torch.distributed.fleet.base.topology, "
            "paddle_tpu_torch.distributed.fleet.meta_parallel, "
            "paddle_tpu_torch.distributed.fleet.meta_parallel.pp_layers, "
            "paddle_tpu_torch.distributed.fleet.meta_parallel."
            "pipeline_parallel, "
            "paddle_tpu_torch.distributed.fleet.meta_parallel."
            "pipeline_schedules, "
            "paddle_tpu_torch.distributed.fleet.meta_parallel."
            "compiled_pipeline, "
            "paddle_tpu_torch.distributed.fleet.meta_parallel.zero_bubble, "
            "paddle_tpu_torch.distributed.fleet.meta_optimizers, "
            "paddle_tpu_torch.distributed.fleet.meta_optimizers."
            "dygraph_optimizer, "
            "paddle_tpu_torch.distributed.fleet.utils."
            "sequence_parallel_utils, "
            "paddle_tpu_torch.distributed.parallel, "
            "paddle_tpu_torch.distributed._zero, "
            "paddle_tpu_torch.distributed._state, "
            "paddle_tpu_torch.distributed.fleet.layers.mpu, "
            "paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops, "
            "paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers, "
            "paddle_tpu_torch.distributed.fleet.layers.mpu.random, "
            "paddle_tpu_torch.serving, paddle_tpu_torch.serving.mesh_engine, "
            "paddle_tpu_torch.observability.sharding, "
            "paddle_tpu_torch.compiler, paddle_tpu_torch.compiler.capture, "
            "paddle_tpu_torch.compiler.patterns, "
            "paddle_tpu_torch.compiler.rewrites, "
            "paddle_tpu_torch.compiler.cleanup, "
            "paddle_tpu_torch.compiler.remat, "
            "paddle_tpu_torch.ops.kernels._ops, "
            "paddle_tpu_torch.distributed.passes, fusion_audit_torch, "
            "paddle_tpu_torch.quantization, "
            "paddle_tpu_torch.quantization.quant, "
            "paddle_tpu_torch.incubate, paddle_tpu_torch.incubate.asp, "
            "paddle_tpu_torch.incubate.optimizer, "
            "paddle_tpu_torch.incubate.distributed.moe_layer, "
            "paddle_tpu_torch.incubate.distributed.models.moe, "
            "paddle_tpu_torch.ops.impl.fused_inference, "
            "paddle_tpu_torch.geometric, paddle_tpu_torch.text, "
            "paddle_tpu_torch.text.datasets, paddle_tpu_torch.audio, "
            "paddle_tpu_torch.audio.datasets, paddle_tpu_torch.version; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


FORBIDDEN = re.compile(r"^\s*(import jax\b|from jax\b|import paddle_tpu\b"
                       r"(?!_torch)|from paddle_tpu[ .](?!_torch))", re.M)


def test_no_module_of_the_port_imports_jax_or_paddle_tpu():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "flash_fwd_ab.py",
              ROOT / "flash_rounding_check.py",
              ROOT / "fusion_audit_torch.py"]
    assert len(files) > 10
    for path in files:
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)}: {hits}"
