"""The port's GenerationEngine against the JAX package's, and the port's
isolation rules.

- greedy ``generate_batch`` on the JAX engine and the port's engine, both
  with the prefix cache, chunked prefill (chunk 8, every prompt longer)
  and mixed steps, more requests than slots and two prompts sharing a
  page-aligned prefix: the tokens must be exactly equal, and the port must
  have served a prefix hit;
- ``fork_request`` mid-decode: the fork's first write into the shared
  partial tail page is a real copy-on-write, and both the parent and the
  fork end with the JAX engine's tokens;
- ``BlockManager`` unit cases, the ones ``tests/test_serving_fastpath.py``
  runs against the JAX package's copy, pointed at the port's copy;
- entry points raise without ``device="cpu"`` when no CUDA card is
  present; ``import paddle_tpu_torch`` pulls in neither ``jax`` nor
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


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"), dict(spec_decode="ngram"),
                                dict(prefix_store=object()), dict(spec_k=2)])
def test_options_of_later_slices_raise(pair, kw):
    with pytest.raises(NotImplementedError, match="slice"):
        GenerationEngine(pair[1], **kw)


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


def test_import_pulls_in_neither_jax_nor_paddle_tpu():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.models, "
            "paddle_tpu_torch.inference, paddle_tpu_torch.weights, "
            "paddle_tpu_torch.ops.kernels; "
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
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)}: {hits}"
