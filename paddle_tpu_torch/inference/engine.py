"""Continuous-batching generation engine over a block-paged KV cache: the
counterpart of ``paddle_tpu/inference/engine.py`` for this slice of the
port.

What it keeps from the JAX engine:

- **slot pool**: a fixed number of running sequences (``max_slots``);
  waiting requests are admitted into free slots between dispatches, in
  (effective priority, arrival) order.
- **block-paged KV cache**: one ``[n_pages, page_size, n_kv_heads,
  head_dim]`` pool per layer for K and for V, in the model's dtype. Each
  slot owns a block table of page ids (``BlockManager``); page 0 is the
  trash page that padding writes land in.
- **int8 KV pages** (``kv_dtype="int8"``): the pools hold int8 codes and
  each layer owns a float32 scale row per page for K and for V
  (``quantization.page_quant``). The dense admission quantizes whole
  pages; the ragged step and every decode step quantize each row as it
  lands (``write_rows``, the offset-0 freeze rule), and attention reads
  the codes through the dequant-fused kernels. CoW copies carry the scale
  rows with the codes. Decode runs the TPU program step by step, not the
  JAX engine's off-TPU dense fallback (which keeps a chunk's new rows in
  float until the chunk ends).
- **copy-on-write prefix cache**: every full page of a finished prefill
  is indexed by a hash chain over its tokens; a later prompt with the same
  prefix maps those pages instead of recomputing them. A write into a
  shared page (a forked sequence's tail) first copies the page.
- **dense prefill admission**: a cold prompt (no prefix hit) no longer
  than ``prefill_chunk`` (any cold prompt when it is None) is admitted
  with the others of its step in one batched dense causal forward
  (``model.paged_prefill``, ``_admit``), padded to a power-of-two
  (rows, tokens) bucket; its KV is then written into freshly assigned
  pages, page by page.
- **chunked prefill and mixed steps**: longer prompts and prompts after a
  prefix hit advance ``prefill_chunk`` tokens per dispatch through the
  ragged program (``model.paged_prefill_ragged``); with ``mixed_step`` the
  running sequences' decode tokens ride the same launch as q_len = 1 rows.
- **decode chunks**: between admissions, up to ``decode_chunk`` decode
  steps (a power of two) run back to back through ``model.paged_decode``.
- **recompute preemption** when the page pool runs out, and requeueing of
  dense admissions that find the pool exhausted.
- **speculative decoding** (``spec_decode=``: a ``speculative.Drafter``,
  ``"ngram"``/``"ngram:<n>"``, or None to consult
  ``PADDLE_TPU_SPEC_DECODE``): in a greedy pool each decode step drafts up
  to ``spec_k`` tokens a slot and verifies every row in ONE ragged launch
  (``model.paged_verify``, q_len = 1 + drafts), committing the longest
  greedy-matching prefix plus the bonus token; rejected pages are trimmed
  (``BlockManager.trim``), and a slot whose acceptance EWMA falls below
  ``spec_min_accept`` serves ``spec_cooldown`` plain rows. Sampling pools,
  no drafts and drafter errors fall back to the plain chunk.
- **the request lifecycle**: trace ids and tenants (``add_request``),
  ``stream``/``astream``/``stream_request`` from any number of threads
  (every consumer steps the shared engine under one lock),
  ``cancel_request``/``cancel_by_trace`` (freed within one step),
  deadlines (``deadline_ms`` of an imported snapshot, swept at the top of
  every step: ``DeadlineExceededError``), sequence checkpoint/restore
  without KV (``export_request``/``remove_request``/``import_request``,
  the wire format of ``make_sequence_snapshot``, interchangeable with the
  JAX engine's) and ``swap_weights`` (prefix index, draft state and the
  weight epoch reset under the step lock).

- **the KV transfer plane**: ``export_kv_pages`` serializes the
  prefix-indexed pages covering a token chain, ``export_request(rid,
  with_kv=True)`` / ``remove_request(rid, with_kv=True)`` a live
  request's written pages, and ``import_kv_pages`` (or a snapshot's
  ``kv``) adopts transferred pages into the prefix index, refusing KV of
  another weights tag, another kv dtype or another shard count; the wire
  is ``serving.kv_transfer``'s ``kvpages/v1``, byte for byte the JAX
  package's. int8 pages travel with their scale rows and keep the
  exporter's frozen scales. With ``prefix_store=`` (a
  ``serving.kv_transfer.PrefixStore``) evicted prefix pages spill into
  the store and admissions refill missing chain pages from it.
- **metrics**: the JAX engine's ``engine_*`` and ``spec_*`` series in
  the port's registry (``observability.metrics.REGISTRY``), under the
  same names and fed at the same points; ``engine.stats`` holds the
  per-engine view chip_smoke.py reads.

What differs:

- no JIT: the JAX engine's compiled programs are the step programs of
  ``programs.py`` — CUDA graphs on the card, captured once per bucket
  (decode (steps, sampling), dense admission (c, s_pad, sampling), ragged
  (c, s_pad, sampling), verify (c, s_pad), CoW copy (n), KV page upload
  (n)) and replayed over static buffers, counted in the JAX engine's
  trace counters (``decode_trace_count``, ``prefill_trace_count``,
  ``ragged_trace_count``, ``spec_trace_count``, ``copy_trace_count``,
  ``upload_trace_count``); on the CPU the same programs run eagerly. The
  dense and ragged batches are padded to power-of-two (rows, tokens)
  buckets and decode chunks to power-of-two lengths, as in JAX, so the
  programs stay few. Pools are updated in place under
  ``torch.inference_mode()`` (``step``, ``fork_request`` and every
  program): the model's parameters are trainable, and a pool written
  inside an autograd graph would hold that graph across steps.
- no request spans and no waste shares: the engine books each dispatch's
  device seconds (``observability.costs.LEDGER.on_dispatch``, split over
  its riders, as the JAX engine does), its KV bytes and its KV events,
  but not the re-prefill waste after a preemption.
- the tensor-parallel hooks (``mesh_devices``, ``kv_shards``,
  ``_prog_suffix``, ``_make_pools`` / ``_pool_shards``, ``_fwd``,
  ``_param_vals`` / ``_buffer_vals`` / ``_param_tensors``, ``_put``,
  ``_note_mesh_dispatch``) are the single-device defaults that
  ``serving.mesh_engine.MeshGenerationEngine`` overrides: one pool
  shard holding every KV head, the model's own forward and parameters,
  and device seconds equal to wall seconds.

Model contract: ``paged_spec()``, ``paged_prefill(ids, lengths)`` ->
(last-real-token logits [C, V], ks, vs [L, C, S_pad, H_kv, hd]),
``paged_prefill_ragged(ids, q_lens,
start_pos, k_pages, v_pages, block_tables, write_pids, write_offs)`` ->
(last-real-token logits [C, V], k_pages, v_pages) and ``paged_decode(
tokens, positions, k_pages, v_pages, block_tables, context_lens,
write_pids, write_offs)`` -> (logits [B, V], k_pages, v_pages), both
writing the batch's KV into the pools in place before attending; with
int8 pools both also take ``k_scales=``/``v_scales=`` (per-layer scale
rows, updated in place) and return them after the pools.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..observability import tracing as _TR
from ..observability.costs import LEDGER as _LEDGER
from ..observability.events import EVENTS as _EVENTS
from ..observability.metrics import REGISTRY as _REG, _ENABLED as _OBS_ON
from ..quantization import page_quant
from .programs import StepPrograms

# the JAX engine's serving series (paddle_tpu/inference/engine.py), same
# names, fed at the same points; process-wide (all engines aggregate)
_C_ADMIT = _REG.counter("engine_admissions_total",
                        "requests admitted into a decode slot")
_C_REQUEUE = _REG.counter("engine_requeues_total",
                          "admissions rolled back to the queue (no pages)")
_C_PREEMPT = _REG.counter("engine_preemptions_total",
                          "mid-decode recompute-style preemptions")
_C_RETIRE = _REG.counter("engine_retired_total", "sequences finished")
_C_TOKENS = _REG.counter("engine_tokens_total", "decode tokens produced")
_C_RECOMP = _REG.counter(
    "engine_recompiles_total",
    "decode/prefill program re-traces after their first compile")
_G_SLOTS = _REG.gauge("engine_slots_total", "slot-pool capacity")
_G_ACTIVE = _REG.gauge("engine_slots_active", "slots decoding right now")
_G_PAGES_TOTAL = _REG.gauge("engine_pages_total",
                            "usable KV pages (excl. trash page)")
_G_PAGES_FREE = _REG.gauge("engine_pages_free", "unallocated KV pages")
_G_TPS = _REG.gauge("engine_decode_tokens_per_sec",
                    "instantaneous decode throughput (last chunk)")
# the waiting-queue depth, process-wide: each engine publishes its depth
# into _QUEUE_DEPTHS and the gauge carries the total over live engines
_G_QUEUE = _REG.gauge("engine_queue_waiting",
                      "requests queued awaiting admission "
                      "(process-wide total over live engines)")
_QUEUE_LOCK = threading.RLock()  # reentrant: a collection inside the
#                                  locked region may run _drop_queue_depth
_QUEUE_DEPTHS = {}               # id(engine) -> depth


def _drop_queue_depth(key):
    with _QUEUE_LOCK:
        _QUEUE_DEPTHS.pop(key, None)
        _G_QUEUE.set(sum(_QUEUE_DEPTHS.values()))


def _set_queue_depth(engine, depth):
    key = id(engine)
    with _QUEUE_LOCK:
        if key not in _QUEUE_DEPTHS:
            weakref.finalize(engine, _drop_queue_depth, key)
        _QUEUE_DEPTHS[key] = depth
        _G_QUEUE.set(sum(_QUEUE_DEPTHS.values()))


_H_OCC = _REG.histogram(
    "engine_batch_occupancy",
    "active slots / max_slots per decode dispatch",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
_H_PREFILL = _REG.histogram("engine_prefill_seconds",
                            "admission batch prefill wall time")
_H_DECODE = _REG.histogram("engine_decode_chunk_seconds",
                           "decode chunk wall time (host-synced)")
_C_PFX_HIT = _REG.counter("engine_prefix_cache_hits_total",
                          "admissions that mapped >=1 cached prefix page")
_C_PFX_MISS = _REG.counter("engine_prefix_cache_misses_total",
                           "admissions with no cached prefix")
_C_PFX_TOK = _REG.counter(
    "engine_prefix_cache_hit_tokens_total",
    "prompt tokens served from cached KV pages (prefill work avoided)")
_C_COW = _REG.counter("engine_cow_copies_total",
                      "copy-on-write page copies (shared page diverged)")
_C_PFX_EVICT = _REG.counter(
    "engine_prefix_evictions_total",
    "cached prefix pages evicted to refill the free list")
_C_CHUNK = _REG.counter("engine_prefill_chunks_total",
                        "chunked-prefill dispatches (ragged program)")
_C_MIXED = _REG.counter(
    "engine_mixed_steps_total",
    "single-launch mixed prefill+decode dispatches (ragged op)")
_H_TTFT = _REG.histogram(
    "engine_ttft_seconds",
    "per-request time-to-first-token (submit -> first sampled token)",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0))
_H_ILV = _REG.histogram(
    "engine_interleave_occupancy",
    "decode rows / total rows per step that carried prefill work",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
_H_RAGGED = _REG.histogram("engine_ragged_seconds",
                           "ragged (chunk/suffix/mixed) dispatch wall time")
# KV pages on the wire and the spill tier
_C_KV_EXP = _REG.counter(
    "engine_kv_pages_exported_total",
    "KV pages serialized off this engine (transfer out)")
_C_KV_IMP = _REG.counter(
    "engine_kv_pages_imported_total",
    "transferred KV pages mapped into this engine's pools (prefill "
    "work avoided without recompute)")
_C_KV_SPILL = _REG.counter(
    "engine_kv_pages_spilled_total",
    "LRU-evicted prefix pages spilled to the prefix store")
_C_KV_REFILL = _REG.counter(
    "engine_kv_pages_refilled_total",
    "prefix pages refilled from the prefix store at admission")
_C_KV_OUT_B = _REG.counter(
    "engine_kv_bytes_total", "KV page bytes serialized/deserialized",
    labels={"dir": "out"})
_C_KV_IN_B = _REG.counter(
    "engine_kv_bytes_total", "KV page bytes serialized/deserialized",
    labels={"dir": "in"})
_C_BUSY = _REG.counter(
    "engine_busy_seconds_total",
    "wall-seconds spent inside compiled dispatches (prefill/ragged/"
    "decode/spec-verify), unsplit")
# speculative decoding: drafted vs accepted
_C_SPEC_DRAFT = _REG.counter(
    "spec_draft_tokens_total",
    "draft tokens offered to the verify dispatch")
_C_SPEC_ACC = _REG.counter(
    "spec_accepted_tokens_total",
    "draft tokens the target model's greedy argmax confirmed")
_C_SPEC_RB = _REG.counter(
    "spec_rollbacks_total",
    "per-slot draft rejections (rejected KV positions/pages rolled "
    "back to the verified prefix)")
_G_SPEC_ACC = _REG.gauge(
    "engine_spec_acceptance_rate",
    "lifetime accepted/drafted draft-token ratio")
_H_SPEC = _REG.histogram(
    "engine_spec_verify_seconds",
    "draft-and-verify dispatch wall time (host-synced)")
# requests that left early: a blown deadline or a cancel verb
_C_DEADLINE = _REG.counter(
    "engine_deadline_exceeded_total",
    "requests expired at a step boundary after blowing deadline_ms")
_C_CANCEL = _REG.counter(
    "engine_cancelled_total",
    "requests torn down by an explicit cancel verb mid-flight")


class PagedGenerationMixin:
    """Engine front door shared by the causal-LM model classes."""

    def get_engine(self, max_slots=4, page_size=16, **kw):
        """Cached GenerationEngine for this model, one per pool shape; a
        small LRU, since each engine owns a full KV pool on the device.
        ``mesh_devices`` / ``fsdp_devices`` above 1 give a tensor-parallel
        ``serving.mesh_engine.MeshGenerationEngine``."""
        cache = self.__dict__.setdefault("_engines", OrderedDict())
        sig = (max_slots, page_size, tuple(sorted(kw.items())))
        eng = cache.pop(sig, None)
        if eng is None:
            if len(cache) >= 4:
                for key in list(cache):     # oldest-first: evict an IDLE
                    if not cache[key].has_work():   # pool
                        del cache[key]
                        break
            if int(kw.get("mesh_devices", 1) or 1) > 1 \
                    or int(kw.get("fsdp_devices", 1) or 1) > 1:
                from ..serving.mesh_engine import MeshGenerationEngine
                eng = MeshGenerationEngine(
                    self, max_slots=max_slots, page_size=page_size, **kw)
            else:
                kw = {k: v for k, v in kw.items()
                      if k not in ("mesh_devices", "fsdp_devices")}
                eng = GenerationEngine(self, max_slots=max_slots,
                                       page_size=page_size, **kw)
        cache[sig] = eng
        return eng

    def generate_batch(self, prompts, max_new_tokens=32, temperature=0.0,
                       seed=None, eos_token_id=None, max_slots=4,
                       page_size=16, **engine_kw):
        """Continuous-batching generation for variable-length prompts (a
        list of 1-D int arrays). Extra kwargs (max_seq_len, n_pages,
        prefix_cache, prefill_chunk, mixed_step, ...) configure the engine.
        Returns a list of np.ndarray(prompt + generated) in input order."""
        self.eval()
        eng = self.get_engine(max_slots=max_slots, page_size=page_size,
                              **engine_kw)
        if seed is not None:
            eng.reseed(seed)
        rids = [eng.add_request(p, max_new_tokens, temperature,
                                eos_token_id) for p in prompts]
        results = eng.run()
        return [results[r] for r in rids]

    def stream_generate(self, prompt, max_new_tokens=32, temperature=0.0,
                        eos_token_id=None, max_slots=4, page_size=16,
                        **engine_kw):
        """Yield generated token ids one at a time through the engine's
        streaming front end (``GenerationEngine.stream``)."""
        with torch.no_grad():
            self.eval()
            eng = self.get_engine(max_slots=max_slots, page_size=page_size,
                                  **engine_kw)
            it = eng.stream(prompt, max_new_tokens, temperature,
                            eos_token_id)
        # no_grad per advance, NOT held across yields: the generator
        # suspends with the caller's grad mode restored, so caller code
        # running between tokens can still build a graph
        while True:
            with torch.no_grad():
                try:
                    tok = next(it)
                except StopIteration:
                    return
            yield tok


def sample_tokens(logits, temps, generator):
    """Greedy where temps == 0, categorical elsewhere. logits [B, V];
    temps [B] float32 on the logits' device (None: all greedy).

    The categorical draw is the exponential race ``argmax(p / E)``, E ~
    Exp(1) from `generator`: the draw ``torch.multinomial(p, 1)`` makes
    (the same numbers from the same generator state), written out so that
    a CUDA graph can capture it (no host check of p)."""
    greedy = torch.argmax(logits.float(), dim=-1)
    if temps is None:
        return greedy
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    probs = torch.softmax(logits.float() / safe_t[:, None], dim=-1)
    race = torch.empty_like(probs).exponential_(1, generator=generator)
    sampled = torch.argmax(probs / race, dim=-1)
    return torch.where(temps > 0, sampled, greedy)


def _next_pow2(n, floor=8):
    p = floor
    while p < n:
        p *= 2
    return p


def _prefix_chain(tokens, page_size):
    """Yield ``(chain_hash, parent_hash, page_tokens)`` per FULL page of
    `tokens` — the one definition of the prefix-index hash chain."""
    h = None
    for blk in range(len(tokens) // page_size):
        lo = blk * page_size
        toks = tuple(int(t) for t in tokens[lo:lo + page_size])
        parent, h = h, hash((h, toks))
        yield h, parent, toks


def prefix_chain_hashes(tokens, page_size):
    """Chain hashes of every FULL page of `tokens`: the chain the prefix
    index is keyed on. Tuples of ints hash the same in every process
    (no string hashing), so a router in another process (or the JAX
    package's) computes the chain a replica's BlockManager indexed."""
    return [h for h, _, _ in _prefix_chain(tokens, page_size)]


new_trace_id = _TR.new_trace_id
sanitize_tenant = _TR.sanitize_tenant


class DeadlineExceededError(RuntimeError):
    """A request blew its end-to-end ``deadline_ms`` budget and was
    expired at a step boundary (slot and pages freed; the tokens already
    delivered stay delivered)."""


class RequestCancelledError(RuntimeError):
    """A request was torn down by ``cancel_request``/``cancel_by_trace``
    before reaching its token budget."""


def make_sequence_snapshot(tokens, prompt0=None, remaining=0,
                           temperature=0.0, eos_token_id=None, priority=0,
                           slo_ms=None, done=False, age_s=0.0,
                           ttft_s=None, trace=None, tenant=None,
                           deadline_ms=None):
    """The serialized per-sequence engine state that ``export_request``
    produces and ``import_request`` consumes — the JAX engine's wire
    format, field for field, in plain Python ints, floats and lists, so a
    snapshot crosses between the two packages. `tokens` holds only
    verified-committed tokens (prompt + delivered output); draft tokens
    never enter it. Clocks travel as ages (``age_s``, ``ttft_s``) and the
    deadline as a budget relative to the original submission."""
    tokens = [int(t) for t in tokens]
    return {
        "v": 1, "tokens": tokens,
        "prompt0": int(len(tokens) if prompt0 is None else prompt0),
        "remaining": int(remaining),
        "temperature": float(temperature),
        "eos_token_id": eos_token_id,
        "priority": int(priority), "slo_ms": slo_ms,
        "done": bool(done), "age_s": float(age_s), "ttft_s": ttft_s,
        "deadline_ms": deadline_ms,
        "trace": trace,
        "tenant": tenant,
    }


class BlockManager:
    """Host-side page allocator: refcounted block tables + a
    copy-on-write prefix index, no storage (the pages live in the
    engine's device pools). Page 0 is reserved as the trash page — block
    tables are padded with it and inactive slots write to it.

    Every FULL page of a completed prefill registers under a chain hash —
    ``hash((parent chain hash, page's tokens))`` — so a page is only ever
    matched through the exact token path that produced its KV. Invariants:

    - shared pages are FULL and never written through a block table,
      except after ``fork``, where both forks point at the parent's
      partial tail page: the first divergent write triggers copy-on-write
      (``ensure_writable``), queueing a device page copy the engine drains
      before dispatching the writer.
    - ``refcount == 0`` + indexed => the page keeps its content and parks
      in an LRU "cached" pool; it is still reclaimable (``free_pages``
      counts it), and allocation evicts LRU cached pages (dropping their
      index entries) before declaring exhaustion.
    - a write into an owned-but-indexed page unregisters it first, so the
      index never lies."""

    def __init__(self, n_pages, page_size, pages_per_slot, max_slots,
                 prefix_cache=False):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.page_size = page_size
        self.n_pages = n_pages
        self.prefix_cache = bool(prefix_cache)
        self._free = list(range(n_pages - 1, 0, -1))   # page 0 reserved
        self.block_tables = np.zeros((max_slots, pages_per_slot), np.int32)
        self.n_blocks = np.zeros(max_slots, np.int32)
        self.refcount = np.zeros(n_pages, np.int32)
        # chain_hash -> (pid, parent_hash, page_tokens): every match
        # verifies the tokens, so a hash collision can never serve another
        # chain's KV
        self._index = {}
        self._hash_of = {}     # pid -> chain_hash (indexed pages only)
        self._cached = OrderedDict()   # pid -> chain_hash; refcount==0 LRU
        self._pending_copies = []      # (src, dst) CoW device copies due
        self.cow_copies = 0
        self.evictions = 0
        # spill hook: called as (pid, chain_hash, parent, toks) when an
        # LRU cached page is evicted, BEFORE the page id is reused, so the
        # engine can still gather its content into the prefix store
        self.on_evict = None

    @property
    def free_pages(self):
        return len(self._free) + len(self._cached)

    def _take_page(self):
        if self._free:
            pid = self._free.pop()
        elif self._cached:
            pid, h = self._cached.popitem(last=False)   # evict LRU
            entry = self._index.pop(h, None)
            self._hash_of.pop(pid, None)
            self.evictions += 1
            _C_PFX_EVICT.inc()
            if entry is not None and entry[0] == pid \
                    and self.on_evict is not None:
                try:      # the content is still in the pools: the pid is
                    #       reused only after this returns
                    self.on_evict(pid, h, entry[1], entry[2])
                except Exception:  # noqa: BLE001 — the spill is
                    pass           # best-effort; allocation never fails
        else:
            raise RuntimeError(
                "paged KV cache exhausted: all "
                f"{self.n_pages - 1} pages in use — retire "
                "sequences, shrink max_slots, or grow n_pages")
        self.refcount[pid] = 1
        return int(pid)

    def _unindex(self, pid):
        h = self._hash_of.pop(pid, None)
        if h is not None:
            entry = self._index.get(h)
            if entry is not None and entry[0] == pid:
                del self._index[h]

    def _cow(self, slot, blk):
        """The slot is about to write into a shared page: give it a
        private copy. The device copy is queued (drain_copies); the
        table/refcounts change now."""
        src = int(self.block_tables[slot, blk])
        dst = self._take_page()
        self._pending_copies.append((src, dst))
        self.cow_copies += 1
        _C_COW.inc()
        self.refcount[src] -= 1        # was > 1: still >= 1
        self.block_tables[slot, blk] = dst

    def ensure_writable(self, slot, start, n_tokens):
        """Copy-on-write sweep for a write of [start, start + n_tokens)."""
        if n_tokens <= 0:
            return
        first = start // self.page_size
        last = (start + n_tokens - 1) // self.page_size
        for blk in range(first, min(last + 1, int(self.n_blocks[slot]))):
            pid = int(self.block_tables[slot, blk])
            if self.refcount[pid] > 1:
                self._cow(slot, blk)
            else:
                self._unindex(pid)

    def drain_copies(self):
        """Queued (src, dst) CoW page copies; the caller MUST execute
        them on the device pools before the next program writes."""
        out, self._pending_copies = self._pending_copies, []
        return out

    def assign(self, slot, start, n_tokens):
        """Page/offset pairs for tokens at positions [start, start +
        n_tokens) of `slot`, allocating pages as crossed and CoW-copying
        any shared page written into. Returns (pids, offs) int32 arrays."""
        self.ensure_writable(slot, start, n_tokens)
        pids = np.empty(n_tokens, np.int32)
        offs = np.empty(n_tokens, np.int32)
        table = self.block_tables[slot]
        for i in range(n_tokens):
            blk, off = divmod(start + i, self.page_size)
            if blk >= self.n_blocks[slot]:
                table[blk] = self._take_page()
                self.n_blocks[slot] = blk + 1
            pids[i] = table[blk]
            offs[i] = off
        return pids, offs

    def release(self, slot):
        """Unmap every page of `slot` (``trim(slot, 0)``)."""
        self.trim(slot, 0)

    def trim(self, slot, n_tokens):
        """Unmap the slot's pages BEYOND those covering positions ``[0,
        n_tokens)``; returns how many were unmapped. ``n_tokens > 0`` is
        the speculative rollback: pages taken for rejected draft positions
        go back now. A still-shared page is only unmapped; an indexed
        refcount-0 page keeps its content and parks MRU in the cached LRU
        pool; the rest return to the free list."""
        keep = 0 if n_tokens <= 0 else -(-int(n_tokens) // self.page_size)
        n = int(self.n_blocks[slot])
        if keep >= n:
            return 0
        for blk in range(n - 1, keep - 1, -1):
            pid = int(self.block_tables[slot, blk])
            self.refcount[pid] -= 1
            if self.refcount[pid] <= 0:
                self.refcount[pid] = 0
                if pid in self._hash_of:
                    self._cached[pid] = self._hash_of[pid]
                    self._cached.move_to_end(pid)
                else:
                    self._free.append(pid)
            self.block_tables[slot, blk] = 0
        self.n_blocks[slot] = keep
        return n - keep

    def fork(self, src_slot, dst_slot):
        """Map dst_slot onto src_slot's pages copy-on-write."""
        n = int(self.n_blocks[src_slot])
        self.block_tables[dst_slot, :n] = self.block_tables[src_slot, :n]
        self.block_tables[dst_slot, n:] = 0
        self.n_blocks[dst_slot] = n
        for p in self.block_tables[src_slot, :n]:
            self.refcount[int(p)] += 1

    def match_prefix(self, tokens, max_tokens=None):
        """Longest chain of cached FULL pages covering a prefix of
        `tokens` (capped at max_tokens so the caller keeps >= 1 token to
        prefill). CLAIMS every matched page (refcount++). Returns
        (pids, n_cached_tokens)."""
        if not self.prefix_cache:
            return [], 0
        limit = len(tokens) if max_tokens is None else \
            min(len(tokens), int(max_tokens))
        pids = []
        for h, parent, toks in _prefix_chain(tokens[:limit],
                                             self.page_size):
            entry = self._index.get(h)
            if entry is None or entry[1] != parent or entry[2] != toks:
                break
            pids.append(entry[0])
        for pid in pids:
            if self.refcount[pid] == 0:
                self._cached.pop(pid, None)
            self.refcount[pid] += 1
        return pids, len(pids) * self.page_size

    def map_shared(self, slot, pids):
        """Point the head of `slot`'s table at claimed shared pages."""
        if pids:
            self.block_tables[slot, :len(pids)] = pids
            self.n_blocks[slot] = len(pids)

    def invalidate_index(self):
        """Drop every prefix-index entry and return the parked cached
        pages to the free list (a weight swap: their KV was computed under
        the old weights). Live sequences keep their pages."""
        self._index.clear()
        self._hash_of.clear()
        while self._cached:
            pid, _ = self._cached.popitem(last=False)
            self._free.append(pid)

    def adopt_page(self, h, parent, toks):
        """Take one page for KV produced elsewhere (a transferred page or
        a prefix-store refill), indexed under the given chain entry and
        parked refcount-0 in the cached pool: matchable by
        ``match_prefix`` and reclaimable, like a page whose owner retired.
        Returns the pid (the caller writes the content into the pools
        before the next program reads it), or None when the hash is
        already indexed. Raises RuntimeError when the pool is exhausted."""
        if not self.prefix_cache or h in self._index:
            return None
        pid = self._take_page()
        self.refcount[pid] = 0
        self._index[h] = (pid, parent, toks)
        self._hash_of[pid] = h
        self._cached[pid] = h
        self._cached.move_to_end(pid)
        return pid

    def register_prefix(self, slot, tokens):
        """Index every FULL page of `slot` whose KV for `tokens` is fully
        written, so later sequences sharing the prefix can map it."""
        if not self.prefix_cache:
            return
        n_full = min(len(tokens) // self.page_size,
                     int(self.n_blocks[slot]))
        for blk, (h, parent, toks) in enumerate(
                _prefix_chain(tokens[:n_full * self.page_size],
                              self.page_size)):
            pid = int(self.block_tables[slot, blk])
            if h not in self._index and pid not in self._hash_of:
                self._index[h] = (pid, parent, toks)
                self._hash_of[pid] = h


@dataclass
class GenRequest:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int
    temperature: float = 0.0
    eos_token_id: int | None = None
    out: list = field(default_factory=list)   # generated token ids
    slot: int = -1                # -1: waiting; >=0: holds that slot
    done: bool = False
    # lower priority = more urgent; a request past half its slo_ms TTFT
    # budget escalates one class. `order` is the arrival number; a
    # preempted request keeps it and re-admits ahead of later arrivals.
    priority: int = 0
    slo_ms: float | None = None
    order: int = 0
    t_submit: float = 0.0
    t_first_token: float | None = None
    n_prefilled: int = 0          # prompt tokens whose KV is in pages
    n_cached: int = 0             # of those, served by the prefix cache
    prompt0: int = 0              # ORIGINAL prompt length (preemption
    #                               folds generated tokens into `prompt`)
    weight_epoch: int = 0         # the engine's weight epoch at admission:
    #                               KV begun under older weights never
    #                               registers in the prefix index
    trace: str | None = None      # request trace id (set at submission or
    #                               taken from an imported snapshot)
    tenant: str | None = None     # owning tenant, as sanitize_tenant gives
    deadline_ms: float | None = None  # end-to-end budget from t_submit,
    #                               swept at step boundaries
    deadline_exceeded: bool = False   # set before `done` by the sweep
    cancelled: bool = False       # set before `done` by a cancel verb
    cancel_reason: str | None = None

    @property
    def n_tokens(self):
        return len(self.prompt) + len(self.out)

    @property
    def n_generated(self):
        """Tokens generated so far, including any that a preemption folded
        into `prompt`."""
        return len(self.prompt) - self.prompt0 + len(self.out)

    def generated_token(self, i):
        """The i-th token of the request's generated sequence, stable
        across preemptions. Lock-free readers race the preemption fold
        (out -> prompt); both sides of the fold rebind rather than mutate,
        so a torn view (out cleared, prompt not yet extended) is retried
        until the writer finishes."""
        for _ in range(100000):
            prompt, out = self.prompt, self.out
            folded = len(prompt) - self.prompt0
            if i < folded:
                return int(prompt[self.prompt0 + i])
            j = i - folded
            if j < len(out):
                return out[j]
            time.sleep(0)
        raise IndexError(
            f"generated token {i} of request {self.rid} never appeared "
            f"({self.n_generated} generated)")

    def effective_priority(self, now):
        if self.slo_ms is not None and \
                (now - self.t_submit) * 1e3 > 0.5 * self.slo_ms:
            return self.priority - 1
        return self.priority


class GenerationEngine:
    """Fixed-capacity continuous-batching engine for one model, on the
    model's device."""

    # the tensor-parallel hooks (serving.mesh_engine overrides them):
    # mesh_devices, the devices behind every dispatch, scales wall time
    # into the DEVICE-seconds the busy counter and the cost ledger book
    # (latency histograms stay wall time); kv_shards, the shard count KV
    # exports are framed with (kvpages/v1 ``shards`` block; imports refuse
    # another count: a single-device engine owns every KV head, one
    # stream); _prog_suffix, appended to every program's introspection
    # label, so that a mesh engine's programs register as their own
    mesh_devices = 1
    kv_shards = 1
    _prog_suffix = ""

    def __init__(self, model, max_slots=4, page_size=16, max_seq_len=None,
                 n_pages=None, cache_dtype=None, kv_dtype=None, seed=None,
                 prefix_cache=True, prefill_chunk=256, mixed_step=None,
                 prefix_store=None, spec_decode=None, spec_k=4,
                 spec_min_accept=0.25, spec_cooldown=16):
        """prefix_cache: share KV pages across requests with a common
        prompt prefix (copy-on-write, see BlockManager). prefill_chunk: max
        prompt tokens prefilled per dispatch (None: whole prompts).
        mixed_step (default on): decode rows ride the prefill chunk's
        ragged launch. cache_dtype: float dtype of the KV pools (default:
        the model's; the float type of non-int8 pools). kv_dtype: "int8"
        stores the pools as int8 codes with one float32 scale per (layer,
        page) beside them; None consults PADDLE_TPU_KV_INT8 and otherwise
        keeps float pools. seed: seeds the sampling generator.
        prefix_store: a ``serving.kv_transfer.PrefixStore``: LRU-evicted
        prefix pages spill into it, and admissions refill missing chain
        pages from it (with a FileStore-backed store, a prompt prefilled
        on any replica is a prefix hit on every other).
        spec_decode: a ``speculative.Drafter``, "ngram"/"ngram:<n>", False
        (off), or None to consult PADDLE_TPU_SPEC_DECODE (a bad or unusable
        ambient value serves plain; an explicit one raises). spec_k: drafts
        per slot and step; spec_min_accept / spec_cooldown: the per-slot
        acceptance EWMA below which a slot serves that many plain rows."""
        if kv_dtype is None:
            env = os.environ.get("PADDLE_TPU_KV_INT8", "")
            if env not in ("", "0", "false", "False"):
                kv_dtype = "int8"
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"unsupported kv_dtype {kv_dtype!r} (None or 'int8')")
        self.kv_dtype = kv_dtype
        if not all(hasattr(model, m) for m in
                   ("paged_prefill", "paged_prefill_ragged", "paged_decode")):
            raise TypeError("the model must implement the paged contract "
                            "(paged_prefill, paged_prefill_ragged, "
                            "paged_decode)")
        spec = model.paged_spec()
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.max_seq_len = int(min(max_seq_len or spec["max_len"],
                                   spec["max_len"]))
        self._pages_per_slot = -(-self.max_seq_len // self.page_size)
        if n_pages is None:
            # full reservation + trash page: never rejects at capacity
            n_pages = 1 + self.max_slots * self._pages_per_slot
        dtype = model.dtype if cache_dtype is None else cache_dtype
        if not dtype.is_floating_point:
            raise ValueError(f"cache_dtype must be a float type, got {dtype} "
                             "(int8 pools: kv_dtype='int8')")
        if self.kv_dtype == "int8":
            dtype = torch.int8
        self._pool_shape = (n_pages, self.page_size, spec["n_kv_heads"],
                            spec["head_dim"])
        self._n_layers = int(spec["n_layers"])
        self._make_pools(dtype)
        pool_bytes = self._pool_bytes()
        _REG.gauge(
            "engine_kv_pool_bytes",
            "device bytes held by the paged KV pools (incl. scale rows)",
            labels={"dtype": str(dtype).replace("torch.", "")}).set(
                pool_bytes)
        self.blocks = BlockManager(n_pages, self.page_size,
                                   self._pages_per_slot, self.max_slots,
                                   prefix_cache=prefix_cache)
        self.prefix_cache = bool(prefix_cache)
        self.prefix_store = prefix_store if self.prefix_cache else None
        if self.prefix_store is not None:
            self.blocks.on_evict = self._spill_page
        _G_SLOTS.set(self.max_slots)
        _G_PAGES_TOTAL.set(n_pages - 1)
        _G_PAGES_FREE.set(self.blocks.free_pages)
        self.prefill_chunk = max(1, int(prefill_chunk)) \
            if prefill_chunk else None
        self.mixed_step = True if mixed_step is None else bool(mixed_step)
        self.decode_chunk = 16         # max decode steps per chunk

        self._slots = [None] * self.max_slots      # slot -> GenRequest
        self._last_tok = np.zeros(self.max_slots, np.int64)
        self._n_ctx = np.zeros(self.max_slots, np.int64)  # tokens in cache
        self._temps = np.zeros(self.max_slots, np.float32)
        self._active = np.zeros(self.max_slots, bool)
        self._prefilling = set()   # slots mid-prefill (not decoding yet)
        self._waiting = []
        self._finished = {}
        self._reqs = {}            # rid -> GenRequest
        self._next_rid = 0
        self._step_lock = threading.Lock()
        self._streaming = set()    # rids a live stream consumes
        # requests that a stream consumer's step retired for a run()
        # caller, held for its next drain (bounded: drop-oldest)
        self._results_bin = OrderedDict()
        self._deadline_rids = set()    # rids with an armed deadline_ms
        # lock fairness: urgent acquirers (cancel, import, stream resolve)
        # register here and step drivers yield after each step meanwhile
        self._urgent_mu = threading.Lock()
        self._step_urgent = 0
        self._weight_epoch = 0         # bumped by swap_weights
        # the prefix store's consistency key: a spilled page is refilled
        # only by an engine holding the same tag (swap_weights moves it)
        self._weights_tag = "init"
        # a per-step host delay (the fault injectors' brownout hook): the
        # engine stays alive and slow; 0.0 is off
        self.step_delay_s = 0.0
        self._gen = torch.Generator(device=self.device)
        if seed is None:
            self._gen.seed()
        else:
            self._gen.manual_seed(int(seed))
        # what a serving run reports (chip_smoke reads these)
        self.stats = {"prefix_hits": 0, "prefix_misses": 0,
                      "prefix_hit_tokens": 0, "prefill_admits": 0,
                      "prefill_s": 0.0, "prefill_tokens": 0, "requeues": 0,
                      "ragged_steps": 0,
                      "ragged_s": 0.0, "decode_chunks": 0, "decode_s": 0.0,
                      "decode_tokens": 0, "mixed_decode_tokens": 0,
                      "decode_steps": 0,
                      "preemptions": 0, "cow_flushes": 0,
                      "cancels": 0, "deadline_exceeded": 0,
                      "spec_dispatches": 0, "spec_rows": 0,
                      "spec_draft_tokens": 0,
                      "spec_accepted_tokens": 0, "spec_tokens": 0,
                      "spec_rollbacks": 0, "spec_fallbacks": {},
                      "spec_verify_s": 0.0, "spec_draft_s": 0.0,
                      "kv_pages_out": 0, "kv_bytes_out": 0,
                      "kv_gather_s": 0.0, "kv_pack_s": 0.0,
                      "kv_pages_in": 0, "kv_bytes_in": 0,
                      "kv_unpack_s": 0.0, "kv_upload_s": 0.0,
                      "kv_pool_bytes": pool_bytes}
        self.ttft_s = deque(maxlen=4096)   # first-token latency per request
        model.eval()

        # the forward the step programs call (the model's own; a mesh
        # engine's runs it shard by shard)
        self._fwd = model
        # compiled step programs (programs.py): CUDA graphs on the card;
        # False (private: the eager twin chip_smoke.py measures) runs every
        # program eagerly through its static buffers, as on the CPU
        self._graphs = self.device.type == "cuda"
        self._programs = StepPrograms(self)
        self.decode_trace_count = 0    # programs built per kind (the JAX
        self.prefill_trace_count = 0   # engine's names; tests assert they
        self.ragged_trace_count = 0    # freeze after warm-up)
        self.copy_trace_count = 0
        self.spec_trace_count = 0      # verify programs
        self.upload_trace_count = 0    # KV page-upload programs

        self.spec_k = max(1, int(spec_k))
        self.spec_min_accept = float(spec_min_accept)
        self.spec_cooldown = max(1, int(spec_cooldown))
        self._spec = None
        self._spec_state = {}          # slot -> {"ewma", "cool"}
        self.spec_env_ignored = None   # (value, reason) of a refused flag
        self.spec_last_error = None    # the last drafter exception
        from .speculative import make_drafter, spec_decode_from_env
        from_env = spec_decode is None
        if from_env:
            spec_decode = spec_decode_from_env(
                os.environ.get("PADDLE_TPU_SPEC_DECODE"))
        if spec_decode:
            if not hasattr(model, "paged_verify"):
                if not from_env:
                    raise ValueError(
                        "spec_decode requires the ragged paged contract on "
                        "the model (paged_verify + paged_prefill_ragged)")
                self.spec_env_ignored = (str(spec_decode)[:40],
                                         "model_contract")
                _EVENTS.record("engine_spec_env_ignored",
                               value=str(spec_decode)[:40],
                               reason="model_contract")
            else:
                try:
                    self._spec = make_drafter(spec_decode)
                except ValueError:
                    if not from_env:
                        raise
                    # an ambient typo serves plain, never fails startup
                    self.spec_env_ignored = (str(spec_decode)[:40],
                                             "unknown_value")
                    _EVENTS.record("engine_spec_env_ignored",
                                   value=str(spec_decode)[:40],
                                   reason="unknown_value")
        self._c_spec_disp = None
        self._c_spec_fb = {}           # reason -> fallback counter
        if self._spec is not None:
            self._spec.bind(self)
            self._c_spec_disp = _REG.counter(
                "engine_spec_dispatches_total",
                "draft-and-verify dispatches routed, by drafter",
                labels={"drafter": self._spec.name})

    def reseed(self, seed):
        self._gen.manual_seed(int(seed))

    # ------------------------------------------------------------------
    # tensor-parallel hooks (serving.mesh_engine overrides them)
    # ------------------------------------------------------------------

    def _make_pools(self, dtype):
        """The KV pools: one ``[n_pages, page, H_kv, D]`` tensor per layer
        for K and V, and for int8 pools the per-(layer, page) scale rows
        (ones, not zeros: a page is attendable before its opening write
        lands; masked by position, but the dequant still runs)."""
        n_pages = self._pool_shape[0]
        self.k_pages = [torch.zeros(self._pool_shape, dtype=dtype,
                                    device=self.device)
                        for _ in range(self._n_layers)]
        self.v_pages = [torch.zeros(self._pool_shape, dtype=dtype,
                                    device=self.device)
                        for _ in range(self._n_layers)]
        self.k_scales = self.v_scales = None
        if self.kv_dtype == "int8":
            self.k_scales = [torch.ones(n_pages, dtype=torch.float32,
                                        device=self.device)
                             for _ in range(self._n_layers)]
            self.v_scales = [torch.ones(n_pages, dtype=torch.float32,
                                        device=self.device)
                             for _ in range(self._n_layers)]

    def _pool_shards(self):
        """(k pools, v pools, k scale rows, v scale rows, head slice) of
        each KV shard, each a per-layer list (the rows None on float
        pools): one shard holding every head on a single device."""
        return [(self.k_pages, self.v_pages, self.k_scales, self.v_scales,
                 slice(None))]

    def _pool_tensors(self):
        """Every pool and scale-row tensor, each once."""
        seen, out = set(), []
        for shard in self._pool_shards():
            for group in shard[:4]:
                for t in group or ():
                    if id(t) not in seen:
                        seen.add(id(t))
                        out.append(t)
        return out

    def _pool_bytes(self):
        return sum(t.numel() * t.element_size() for t in self._pool_tensors())

    def _put(self, x):
        """Host array -> a tensor on the engine's device."""
        return torch.as_tensor(x, device=self.device)

    def _param_vals(self):
        """The parameters the step programs read, in
        ``model.named_parameters()`` order."""
        return [p for _, p in self.model.named_parameters()]

    def _buffer_vals(self):
        return list(self.model.buffers())

    def _param_tensors(self):
        """Every weight tensor the step programs read (parameters and
        buffers): the addresses a CUDA graph holds."""
        return self._param_vals() + self._buffer_vals()

    def _note_mesh_dispatch(self, program, t0, now):
        """Per-dispatch hook of a mesh engine (the collective traffic of
        `program`, a (kind, key) pair); a single device moves none."""
        return None

    def _weights_loaded(self):
        """After swap_weights' loader ran: a mesh engine re-places its
        weights from the model's."""
        return None

    def _program_scope(self, kind, key):
        """A context around the first (eager) run of program (kind, key):
        a mesh engine records the program's collectives in it."""
        return contextlib.nullcontext()

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------

    def _scales(self):
        """The scale rows the paged model calls take (none for float
        pools); they are updated in place."""
        if self.k_scales is None:
            return {}
        return {"k_scales": self.k_scales, "v_scales": self.v_scales}

    def _flush_cow(self):
        """Execute queued copy-on-write page copies on the device pools.
        MUST run before any dispatch writes through a CoW'd table and
        before any release that could recycle a src/dst page."""
        copies = self.blocks.drain_copies()
        if not copies:
            return
        # one copy program per power-of-two count; padding pairs copy the
        # trash page onto itself
        n = _next_pow2(len(copies), floor=1)
        src = np.zeros(n, np.int64)
        dst = np.zeros(n, np.int64)
        for i, (s, d) in enumerate(copies):
            src[i], dst[i] = s, d
        self._programs.run("copy", (n,), {"src": src, "dst": dst},
                           self._copy_program)
        self.stats["cow_flushes"] += 1

    def _book_dispatch(self, kind, program, t0, now, riders):
        """Book one dispatch's window: busy device seconds (wall x
        mesh_devices), the cost ledger's split over `riders` ((trace,
        tenant, weight[, kind]) tuples, the JAX engine's), and the mesh
        engine's per-dispatch hook."""
        _C_BUSY.inc((now - t0) * self.mesh_devices)
        if _OBS_ON[0]:
            _LEDGER.on_dispatch(kind, now - t0, riders,
                                n_devices=self.mesh_devices)
        self._note_mesh_dispatch(program, t0, now)

    def _copy_program(self, inputs):
        """The CoW copy step: dst pages take the src pages' content in
        every pool; int8 scale rows ride along (a copied page keeps its
        frozen scale)."""
        src, dst = inputs["src"], inputs["dst"]
        for pool in self._pool_tensors():
            pool[dst] = pool[src]

    def _upload_pages(self, pids, k_rows, v_rows, k_sc=None, v_sc=None):
        """Write adopted pages' content into the pools in ONE upload
        program (a power-of-two bucket of pages; the padding goes to trash
        page 0).
        `k_rows`/`v_rows`: CPU tensors ``[L, n, page, H, D]`` in the wire
        dtype, cast to the pools'; `pids` the adopted page ids, in order;
        `k_sc`/`v_sc`: ``[L, n]`` scale rows, required on int8 pools (an
        adopted page keeps the exporter's frozen scale bit for bit). The
        caller has flushed queued CoW copies."""
        n = len(pids)
        if n == 0:
            return
        int8 = self.k_scales is not None
        if int8 and (k_sc is None or v_sc is None):
            raise ValueError(
                "int8 KV pool upload requires per-page scale rows")
        m = _next_pow2(n, floor=1)
        dst = np.zeros(m, np.int64)
        dst[:n] = np.asarray(pids, np.int64)
        # the staged rows fill the bucket's first n pages; the padding rows
        # keep what the staging buffer held (zeros, or an earlier upload's
        # pages) and land in trash page 0, never read as context
        full = (k_rows.shape[0], m) + tuple(k_rows.shape[2:])
        host = {"k_rows": k_rows, "v_rows": v_rows, "dst": dst}
        if int8:
            for name, sc in (("k_srow", k_sc), ("v_srow", v_sc)):
                row = np.ones((self._n_layers, m), np.float32)
                row[:, :n] = np.asarray(sc, np.float32)
                host[name] = row
        self._programs.run("upload", (m, k_rows.dtype), host,
                           self._upload_program,
                           shapes={"k_rows": full, "v_rows": full})

    def _upload_program(self, inputs):
        """The KV page upload: the staged pages (and, int8, their scale
        rows) scattered into every pool at the adopted page ids."""
        dst = inputs["dst"]
        seen = set()
        for kp, vp, ks, vs, heads in self._pool_shards():
            for rows, pools in ((inputs["k_rows"], kp),
                                (inputs["v_rows"], vp)):
                for li, pool in enumerate(pools):
                    pool.index_copy_(0, dst, rows[li][:, :, heads]
                                     .to(pool.dtype))
            if ks is None:
                continue
            for rows, scales in ((inputs["k_srow"], ks),
                                 (inputs["v_srow"], vs)):
                for li, sc in enumerate(scales):
                    if id(sc) not in seen:     # rows shared by shards
                        seen.add(id(sc))
                        sc.index_copy_(0, dst, rows[li])

    def _gather_pages(self, pids):
        """Host copies of the listed pages: CPU tensors ``[L, n, page, H,
        D]`` for K and V (the pools' dtype) and ``[L, n]`` float32 scale
        rows (None on float pools): the serialization source. On the card
        the pages are gathered on the device and come over in one copy
        into one pinned buffer."""
        idx = self._put(np.asarray(pids, np.int64))
        shards = self._pool_shards()
        dtype = shards[0][0][0].dtype
        shape = (2, self._n_layers, len(pids)) + self._pool_shape[1:]
        on_card = self.device.type == "cuda"
        with torch.no_grad():
            host = torch.empty(shape, dtype=dtype, pin_memory=on_card)
            dev = torch.empty(shape, dtype=dtype,
                              device=self.device) if on_card else host
            for kp, vp, _ks, _vs, heads in shards:
                for side, pools in enumerate((kp, vp)):
                    for li, p in enumerate(pools):
                        if heads == slice(None):
                            torch.index_select(p, 0, idx, out=dev[side, li])
                        else:      # this shard's heads of every page
                            dev[side, li][:, :, heads] = torch.index_select(
                                p, 0, idx.to(p.device)).to(self.device)
            sc = None
            _kp, _vp, k_sc, v_sc, _h = shards[0]    # rows shared by shards
            if k_sc is not None:
                sc = torch.stack([torch.stack([s[idx] for s in scales])
                                  for scales in (k_sc, v_sc)]).cpu()
            if on_card:
                host.copy_(dev)        # one copy; it syncs
        if sc is None:
            return host[0], host[1], None, None
        return host[0], host[1], sc[0], sc[1]

    def _admit(self, admissions):
        """Prefill a batch of (req, slot) pairs — cold prompts that fit one
        chunk, their slots already claimed by step() — in ONE dense causal
        forward (``model.paged_prefill``): assign each prompt's pages, write
        its KV into them and sample its first token.

        When the pool runs out mid-batch, the failed request's partial
        pages are rolled back, and it and every request after it are
        unclaimed and requeued at the FRONT of the queue, to retry once
        running sequences retire; this raises only when nothing is running
        that could ever free pages."""
        admitted = []
        for idx, (req, slot) in enumerate(admissions):
            try:
                self.blocks.assign(slot, 0, len(req.prompt))
            except RuntimeError:
                self._flush_cow()              # before any page recycles
                self.blocks.release(slot)      # roll back partial pages
                for r, s in admissions[idx:]:  # unclaim + requeue (front)
                    self._slots[s] = None
                    self._active[s] = False
                    r.slot = -1
                self._waiting[:0] = [r for r, _ in admissions[idx:]]
                _set_queue_depth(self, len(self._waiting))
                _C_REQUEUE.inc(len(admissions) - idx)
                self.stats["requeues"] += len(admissions) - idx
                if not admitted and not any(r is not None
                                            for r in self._slots):
                    raise   # nothing running will ever free pages
                break
            admitted.append((req, slot))
        if not admitted:
            return
        self._flush_cow()   # queued CoW copies land before this write
        c = _next_pow2(len(admitted), floor=1)
        s_max = max(len(req.prompt) for req, _ in admitted)
        s_pad = min(_next_pow2(s_max), self.max_seq_len)
        n_pg = -(-s_pad // self.page_size)
        ids = np.zeros((c, s_pad), np.int64)
        lens = np.ones(c, np.int32)      # dummy rows: length 1, trash writes
        page_ids = np.zeros((c, n_pg), np.int64)   # padding -> trash page 0
        temps = np.zeros(c, np.float32)
        for i, (req, slot) in enumerate(admitted):
            ids[i, :len(req.prompt)] = req.prompt
            lens[i] = len(req.prompt)
            used = int(self.blocks.n_blocks[slot])
            page_ids[i, :used] = self.blocks.block_tables[slot, :used]
            temps[i] = req.temperature

        t0 = time.perf_counter()
        sampling = bool(np.any(temps > 0))
        host = {"ids": ids, "lens": lens, "page_ids": page_ids}
        if sampling:
            host["temps"] = temps
        # the host copy after the program syncs and closes the window
        toks_np = self._programs.run("prefill", (c, s_pad, sampling), host,
                                     self._prefill_program).cpu().numpy()
        now = time.perf_counter()
        _H_PREFILL.observe(now - t0)
        self._book_dispatch(
            "prefill", ("prefill", (c, s_pad, sampling)), t0, now,
            [(r.trace, r.tenant, len(r.prompt)) for r, _ in admitted])
        _C_ADMIT.inc(len(admitted))
        self.stats["prefill_admits"] += 1
        self.stats["prefill_s"] += now - t0
        self.stats["prefill_tokens"] += int(lens[:len(admitted)].sum())

        for i, (req, slot) in enumerate(admitted):
            tok = int(toks_np[i])
            req.out.append(tok)
            req.n_prefilled = len(req.prompt)
            self._last_tok[slot] = tok
            self._n_ctx[slot] = len(req.prompt)
            self._active[slot] = True
            if req.t_first_token is None:
                self._note_first_token(req, now)
            if req.weight_epoch == self._weight_epoch:
                self.blocks.register_prefix(slot, req.prompt)
            self._retire_if_done(req)

    def _prefill_program(self, inputs):
        """The dense admission step: ``paged_prefill``, the pool write
        (``_write_prefill``) and each row's first token."""
        logits, ks, vs = self._fwd.paged_prefill(inputs["ids"],
                                                 inputs["lens"])
        self._write_prefill(ks, vs, inputs["page_ids"])
        return sample_tokens(logits, inputs.get("temps"), self._gen)

    def _write_prefill(self, ks, vs, page_ids):
        """Write a dense prefill's ks/vs [L, C, S_pad, H_kv, hd] into the
        pools, one whole page per (row, page) in the page ids [C, n_pg]
        (in the pools' dtype). Page ids past a row's pages are the trash
        page 0, which takes the padding (several rows may write it; its
        content is never read as context).

        int8 pools: each (layer, row, page) is quantized whole
        (``quantize_pages``) and its scale written beside it. A page's
        absmax covers every position of it that the forward computed,
        including the rows between a prompt's length and S_pad (K/V of pad
        token 0, not zeros), as the JAX program's does; only the tail
        padding up to whole pages is zeros."""
        for kv, pools, scales in ((ks, self.k_pages, self.k_scales),
                                  (vs, self.v_pages, self.v_scales)):
            pages = self._prefill_pages(kv, page_ids.shape[1])
            if scales is not None:
                pages, page_scales = page_quant.quantize_pages(pages)
            flat = page_ids.reshape(-1)
            for li, pool in enumerate(pools):
                pool[flat] = pages[li].to(pool.dtype)
                if scales is not None:
                    scales[li][flat] = page_scales[li]

    def _prefill_pages(self, kv, n_pg):
        """A dense prefill's kv [L, C, S_pad, H, hd] as whole pages [L,
        C * n_pg, page, H, hd] (the tail padded with zeros)."""
        n_layers, c, s_pad = kv.shape[:3]
        pad = n_pg * self.page_size - s_pad
        if pad:
            kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, pad))
        return kv.reshape(n_layers, c * n_pg, self.page_size, *kv.shape[3:])

    def _assign_or_preempt(self, work, slot, start, n):
        """Assign pages for one row of the ragged dispatch, preempting the
        least-urgent running sequence on pool exhaustion. A preempted
        victim's rows are dropped from `work` (rows are (slot, ...)
        tuples). Returns (pids, offs), or None when `slot` itself was the
        victim; raises when this sequence alone exceeds the pool."""
        while True:
            try:
                return self.blocks.assign(slot, start, n)
            except RuntimeError:
                others = any(r is not None
                             for j, r in enumerate(self._slots) if j != slot)
                victim = self._pick_victim()
                if victim == slot and not others:
                    raise   # this sequence alone exceeds the pool
                self._preempt(victim)
                work[:] = [w for w in work if w[0] != victim]
                if victim == slot:
                    return None

    def _ragged_step(self, prefill_slots, decode_slots):
        """ONE ragged dispatch: the next prefill chunk of every mid-prefill
        slot plus (mixed mode) one decode token of every running slot,
        each row a token window at the tail of its own paged context."""
        work = []      # (slot, kind, toks, start, pids, offs)
        for slot in prefill_slots:
            req = self._slots[slot]
            if req is None or slot not in self._prefilling:
                continue
            start = req.n_prefilled
            n = len(req.prompt) - start
            if self.prefill_chunk is not None:
                n = min(n, self.prefill_chunk)
            got = self._assign_or_preempt(work, slot, start, n)
            if got is not None:
                work.append((slot, "prefill",
                             req.prompt[start:start + n], start) + got)
        for slot in decode_slots:
            req = self._slots[slot]
            if req is None or slot in self._prefilling:
                continue
            pos = int(self._n_ctx[slot])
            got = self._assign_or_preempt(work, slot, pos, 1)
            if got is not None:
                work.append((slot, "decode", [self._last_tok[slot]], pos)
                            + got)
        if not work:
            return

        arrays = self._ragged_arrays(
            [(slot, toks, start, pids, offs)
             for slot, _kind, toks, start, pids, offs in work])
        temps = np.zeros(len(arrays[0]), np.float32)
        for i, w in enumerate(work):
            temps[i] = self._slots[w[0]].temperature
        self._flush_cow()   # CoW copies land before this dispatch writes
        t0 = time.perf_counter()
        toks_np = self._ragged_launch(*arrays, temps)
        now = time.perf_counter()
        _H_RAGGED.observe(now - t0)
        # each rider's slice of the fused window by its row's tokens,
        # booked under its own kind
        self._book_dispatch(
            "decode", ("ragged", (*arrays[0].shape, bool(np.any(temps > 0)))),
            t0, now, [(self._slots[w[0]].trace, self._slots[w[0]].tenant,
                       max(1, len(w[2])), w[1]) for w in work
                      if self._slots[w[0]] is not None])
        n_pf = sum(1 for w in work if w[1] == "prefill")
        n_dec = len(work) - n_pf
        _C_CHUNK.inc(n_pf)
        if n_dec:
            _C_MIXED.inc()
        _H_ILV.observe(n_dec / len(work))

        produced = 0
        for i, (slot, kind, toks, start, _p, _o) in enumerate(work):
            req = self._slots[slot]
            tok = int(toks_np[i])
            if kind == "prefill":
                req.n_prefilled = start + len(toks)
                if req.n_prefilled >= len(req.prompt):
                    # final chunk: tok is the first generated token
                    self._prefilling.discard(slot)
                    self._active[slot] = True
                    self._last_tok[slot] = tok
                    self._n_ctx[slot] = len(req.prompt)
                    req.out.append(tok)
                    if req.t_first_token is None:
                        self._note_first_token(req, now)
                    if req.weight_epoch == self._weight_epoch:
                        # a chunked prefill that straddled a weight swap
                        # holds mixed-epoch KV: never index it
                        self.blocks.register_prefix(slot, req.prompt)
                    _C_ADMIT.inc()
                    self._retire_if_done(req)
            else:
                req.out.append(tok)
                produced += 1
                self.stats["mixed_decode_tokens"] += 1
                self._last_tok[slot] = tok
                self._n_ctx[slot] += 1
                self._retire_if_done(req)
        if produced:
            _C_TOKENS.inc(produced)
        _G_ACTIVE.set(sum(r is not None for r in self._slots))
        _G_PAGES_FREE.set(self.blocks.free_pages)

    def _ragged_arrays(self, rows):
        """Host arrays of one ragged dispatch over rows (slot, tokens,
        start, pids, offs), padded to a power-of-two (c, s_pad) bucket:
        (ids, q_lens, start_pos, block tables, write pids, write offsets).
        Dummy rows take q_len 1 and write the trash page 0."""
        c = _next_pow2(len(rows), floor=1)
        s_pad = _next_pow2(max(len(r[1]) for r in rows), floor=1)
        ids = np.zeros((c, s_pad), np.int64)
        q_lens = np.ones(c, np.int32)       # dummy rows: 1 trash token
        start_pos = np.zeros(c, np.int32)
        bt = np.zeros((c, self._pages_per_slot), np.int32)  # trash page 0
        wpid = np.zeros((c, s_pad), np.int64)
        woff = np.zeros((c, s_pad), np.int64)
        for i, (slot, toks, start, pids, offs) in enumerate(rows):
            n = len(toks)
            ids[i, :n] = toks
            q_lens[i] = n
            start_pos[i] = start
            nb = int(self.blocks.n_blocks[slot])
            bt[i, :nb] = self.blocks.block_tables[slot, :nb]
            wpid[i, :n] = pids
            woff[i, :n] = offs
        return ids, q_lens, start_pos, bt, wpid, woff

    def _ragged_launch(self, ids, q_lens, start_pos, bt, wpid, woff,
                       temps):
        """Run one ragged step (``model.paged_prefill_ragged``) on explicit
        host arrays and sample each row's next token from its last real
        position. Returns the tokens [c] (a host copy, which syncs)."""
        t0 = time.perf_counter()
        sampling = bool(np.any(temps > 0))
        host = self._ragged_inputs(ids, q_lens, start_pos, bt, wpid, woff)
        if sampling:
            host["temps"] = temps
        # the host copy after the program syncs and closes the window
        toks_np = self._programs.run("ragged", (*ids.shape, sampling), host,
                                     self._ragged_program).cpu().numpy()
        self.stats["ragged_steps"] += 1
        self.stats["ragged_s"] += time.perf_counter() - t0
        return toks_np

    @staticmethod
    def _ragged_inputs(ids, q_lens, start_pos, bt, wpid, woff):
        return {"ids": ids, "q_lens": q_lens, "start_pos": start_pos,
                "bt": bt, "wpid": wpid, "woff": woff}

    def _ragged_model_args(self, inputs):
        return (inputs["ids"], inputs["q_lens"], inputs["start_pos"],
                self.k_pages, self.v_pages, inputs["bt"], inputs["wpid"],
                inputs["woff"])

    def _ragged_program(self, inputs):
        """The ragged step: ``paged_prefill_ragged`` and each row's next
        token from its last real position."""
        logits = self._fwd.paged_prefill_ragged(
            *self._ragged_model_args(inputs), **self._scales())[0]
        return sample_tokens(logits, inputs.get("temps"), self._gen)

    def _verify_program(self, inputs):
        """The verify step: ``paged_verify`` and the greedy argmax at every
        position."""
        logits = self._fwd.paged_verify(
            *self._ragged_model_args(inputs), **self._scales())[0]
        return torch.argmax(logits.float(), dim=-1)

    def _verify_launch(self, ids, q_lens, start_pos, bt, wpid, woff):
        """The speculative verify dispatch on explicit host arrays: the
        ragged step with the head at every position (``model.paged_verify``)
        and its greedy argmax on the device. Returns the argmaxes
        [c, s_pad] (one host copy, which syncs); only positions below a
        row's q_len mean anything."""
        t0 = time.perf_counter()
        toks_np = self._programs.run(
            "verify", ids.shape, self._ragged_inputs(
                ids, q_lens, start_pos, bt, wpid, woff),
            self._verify_program).cpu().numpy()
        self.stats["spec_dispatches"] += 1
        self.stats["spec_verify_s"] += time.perf_counter() - t0
        return toks_np

    def _grow_for_chunk(self, active, k):
        """Allocate every page the next k tokens of each active slot cross
        into (CoW-copying shared pages written through), preempting on
        exhaustion. Returns the slots still active."""
        for i in active:
            if self._slots[i] is None:
                continue               # preempted on a prior slot
            pos = int(self._n_ctx[i])
            while True:
                need = (pos + k - 1) // self.page_size >= \
                    int(self.blocks.n_blocks[i])
                try:
                    if need:
                        self.blocks.assign(i, pos, k)
                    else:
                        self.blocks.ensure_writable(i, pos, k)
                except RuntimeError:
                    # "alone in the pool" counts EVERY slot holding pages
                    others = any(self._slots[j] is not None
                                 for j in range(self.max_slots) if j != i)
                    victim = self._pick_victim()
                    if victim == i and not others:
                        raise      # one sequence alone exceeds the pool
                    self._preempt(victim)
                    if victim == i:
                        break
                    continue
                break
        return [i for i in active if self._slots[i] is not None]

    def _decode_chunk(self, active, k):
        """k decode steps for the whole slot pool; idle slots write the
        trash page and keep their token."""
        temps = None
        if np.any(self._temps[np.asarray(active)] > 0):
            temps = self._temps
        t0 = time.perf_counter()
        toks_np = self._decode_launch(self._last_tok, self._n_ctx,
                                      self._active, k, temps)
        now = time.perf_counter()
        elapsed = now - t0
        _H_DECODE.observe(elapsed)
        # every rider rode the same k fused steps: equal shares
        self._book_dispatch(
            "decode", ("decode", (k, temps is not None)), t0, now,
            [(self._slots[i].trace, self._slots[i].tenant, k)
             for i in active])
        _H_OCC.observe(len(active) / self.max_slots)

        produced = 0
        for i in active:
            req = self._slots[i]
            self._n_ctx[i] += k
            self._last_tok[i] = int(toks_np[k - 1, i])
            for t in range(k):
                req.out.append(int(toks_np[t, i]))
                produced += 1
                if (req.eos_token_id is not None
                        and req.out[-1] == req.eos_token_id):
                    break              # tail of the chunk is discarded
            self._retire_if_done(req)
        self.stats["decode_tokens"] += produced
        _C_TOKENS.inc(produced)
        _G_ACTIVE.set(sum(r is not None for r in self._slots))
        _G_PAGES_FREE.set(self.blocks.free_pages)
        if elapsed > 0:
            _G_TPS.set(produced / elapsed)

    def _decode_launch(self, tokens, positions, active, steps, temps=None):
        """`steps` decode steps of the whole slot pool on explicit host
        arrays (tokens, positions, active [max_slots]; temps [max_slots] or
        None for greedy). Each step writes an active slot's token at its
        position through the block table (whose pages the caller has
        assigned) and attends over position + 1 keys; idle slots write the
        trash page and keep their token. Returns the tokens [steps,
        max_slots] (one host copy, which syncs)."""
        t0 = time.perf_counter()
        sampling = temps is not None
        host = {"tokens": np.asarray(tokens, np.int64),
                "positions": np.asarray(positions, np.int64),
                "active": np.asarray(active, bool),
                "bt": self.blocks.block_tables}
        if sampling:
            host["temps"] = np.asarray(temps, np.float32)
        toks_np = self._programs.run(       # [steps, B]; the host copy syncs
            "decode", (steps, sampling), host,
            lambda inputs: self._decode_program(steps, inputs)).cpu().numpy()
        self.stats["decode_chunks"] += 1
        self.stats["decode_steps"] += steps
        self.stats["decode_s"] += time.perf_counter() - t0
        return toks_np

    def _decode_program(self, steps, inputs):
        """The decode chunk: `steps` decode steps of the whole slot pool,
        sampling included, each feeding the next on the device."""
        page = self.page_size
        active, bt = inputs["active"], inputs["bt"]
        tokens, positions = inputs["tokens"], inputs["positions"]
        temps = inputs.get("temps")
        rows = torch.arange(self.max_slots, device=self.device)
        zero = torch.zeros((), dtype=torch.long, device=self.device)
        out = []
        for _ in range(steps):
            ctx = torch.where(active, positions + 1, zero).to(torch.int32)
            wp = torch.where(active, bt[rows, positions // page].long(), zero)
            wo = torch.where(active, positions % page, zero)
            logits = self._fwd.paged_decode(
                tokens, positions, self.k_pages, self.v_pages, bt, ctx, wp,
                wo, **self._scales())[0]
            tokens = torch.where(
                active, sample_tokens(logits, temps, self._gen), tokens)
            positions = torch.where(active, positions + 1, positions)
            out.append(tokens)
        return torch.stack(out)

    # ------------------------------------------------------------------
    # speculative decoding: draft-and-verify decode dispatch
    # ------------------------------------------------------------------

    def _spec_fallback(self, reason):
        fb = self.stats["spec_fallbacks"]
        fb[reason] = fb.get(reason, 0) + 1
        c = self._c_spec_fb.get(reason)
        if c is None:
            c = self._c_spec_fb[reason] = _REG.counter(
                "engine_spec_fallbacks_total",
                "spec steps that fell back to the plain fused decode "
                "chunk, by reason", labels={"reason": reason})
        c.inc()

    def _spec_drop(self, slot):
        """Forget a slot's draft state (retire, preempt, cancel, remove):
        the drafter's per-slot state and the acceptance EWMA key on the
        slot id, which is about to be reused."""
        if self._spec is not None:
            self._spec.drop_slot(slot)
            self._spec_state.pop(slot, None)

    def _spec_step(self, active):
        """ONE draft-and-verify dispatch for the decode batch: draft up to
        ``spec_k`` tokens a slot, verify every row in one ragged launch
        (q_len = 1 + drafts), commit the longest greedy-matching draft
        prefix plus the bonus token, stopping mid-bundle at EOS or the
        budget, and trim the pages of rejected positions. Returns False
        to fall back to the plain chunk: a sampling pool (verify is greedy
        only), no slot proposing a draft, or a drafter error. Slots whose
        acceptance EWMA collapsed serve a plain-row cooldown."""
        arr = np.asarray(active)
        if bool(np.any(self._temps[arr] > 0)):
            self._spec_fallback("sampling")
            return False

        # per-slot budget: never past the new-token budget (accepting a
        # drafts commits a + 1 tokens) or the slot's page capacity
        live, caps = {}, {}
        for i in active:
            req = self._slots[i]
            st = self._spec_state.setdefault(i, {"ewma": 1.0, "cool": 0})
            if st["cool"] > 0:
                st["cool"] -= 1
                if st["cool"] == 0:
                    st["ewma"] = 1.0     # parole: draft again
                caps[i] = 0
                continue
            remaining = req.max_new_tokens - len(req.out)
            n = int(self._n_ctx[i]) + 1
            caps[i] = max(0, min(self.spec_k, remaining - 1,
                                 self.max_seq_len - n))
            if caps[i] > 0:
                # a drafter reading only recent history declares it, so a
                # long context is not copied per slot per dispatch
                w = self._spec.history_window
                out_arr = np.asarray(
                    req.out if w is None else req.out[-w:], np.int32)
                head = req.prompt if w is None else \
                    req.prompt[max(0, len(req.prompt)
                                   - (w - out_arr.size)):]
                live[i] = np.concatenate([head, out_arr]) \
                    if len(head) else out_arr
        t0 = time.perf_counter()
        try:
            # no more than the largest per-slot budget: a model drafter
            # runs a decode step per requested token
            k_ask = min(self.spec_k, max(caps.values())) if live else 0
            proposals = self._spec.propose(live, k_ask) if live else {}
        except Exception as e:  # noqa: BLE001 — drafting is optional,
            #                     decoding is not
            self.spec_last_error = e
            self._spec_fallback("drafter_error")
            return False
        finally:
            self.stats["spec_draft_s"] += time.perf_counter() - t0
        drafts = {i: [int(t) for t in proposals.get(i, ())][:caps[i]]
                  for i in active}
        if not any(drafts.values()):
            self._spec_fallback("no_drafts")
            return False

        work = []      # (slot, drafts, pids, offs)
        for slot in active:
            if self._slots[slot] is None:   # preempted by an earlier row
                continue
            d = drafts.get(slot, [])
            got = self._assign_or_preempt(work, slot,
                                          int(self._n_ctx[slot]), 1 + len(d))
            if got is None:
                continue
            work.append((slot, d) + got)
        if not work:
            return True            # everything preempted: step spent

        arrays = self._ragged_arrays(
            [(slot, [self._last_tok[slot]] + d, int(self._n_ctx[slot]),
              pids, offs) for slot, d, pids, offs in work])
        self._flush_cow()   # CoW copies land before this dispatch writes
        t0 = time.perf_counter()
        toks_np = self._verify_launch(*arrays)
        now = time.perf_counter()
        _H_SPEC.observe(now - t0)
        self._book_dispatch(
            "spec_verify", ("verify", arrays[0].shape), t0, now,
            [(self._slots[w[0]].trace, self._slots[w[0]].tenant,
              1 + len(w[1])) for w in work
             if self._slots[w[0]] is not None])
        if self._c_spec_disp is not None:
            self._c_spec_disp.inc()
        self.stats["spec_rows"] += len(work)

        st_all = self.stats
        produced = drafted = accepted = 0
        for i, (slot, d, _pids, _offs) in enumerate(work):
            req = self._slots[slot]
            if req is None:
                continue
            m = len(d)
            g = toks_np[i]
            a = 0
            while a < m and d[a] == int(g[a]):
                a += 1
            # commit g[0..a]: the confirmed drafts and the bonus token,
            # stopping mid-bundle at EOS or at the budget
            for t in g[:a + 1]:
                req.out.append(int(t))
                produced += 1
                st_all["spec_tokens"] += 1
                if (req.eos_token_id is not None
                        and req.out[-1] == req.eos_token_id):
                    break          # the tail of the bundle is discarded
                if len(req.out) >= req.max_new_tokens:
                    break
            self._last_tok[slot] = req.out[-1]
            self._n_ctx[slot] = len(req.prompt) + len(req.out) - 1
            if m:
                drafted += m
                accepted += a
                st_all["spec_draft_tokens"] += m
                st_all["spec_accepted_tokens"] += a
                st = self._spec_state.setdefault(
                    slot, {"ewma": 1.0, "cool": 0})
                st["ewma"] = 0.7 * st["ewma"] + 0.3 * (a / m)
                if a < m:
                    st_all["spec_rollbacks"] += 1
                    _C_SPEC_RB.inc()
                    # rejected positions' pages go back now; stale KV in
                    # kept pages sits past the context and is masked by
                    # position, then overwritten by the next write
                    self.blocks.trim(slot, int(self._n_ctx[slot]) + 1)
                if st["ewma"] < self.spec_min_accept:
                    st["cool"] = self.spec_cooldown
                if req.tenant and _TR.tenant_tracked(req.tenant):
                    _REG.counter(
                        "spec_draft_tokens_total",
                        "draft tokens offered to the verify dispatch",
                        labels={"tenant": req.tenant}).inc(m)
                    _REG.counter(
                        "spec_accepted_tokens_total",
                        "draft tokens the target model's greedy argmax "
                        "confirmed",
                        labels={"tenant": req.tenant}).inc(a)
                self._spec.observe(slot, a, m)
            self._retire_if_done(req)
        if drafted:
            _C_SPEC_DRAFT.inc(drafted)
            _C_SPEC_ACC.inc(accepted)
        if _C_SPEC_DRAFT.value:
            _G_SPEC_ACC.set(_C_SPEC_ACC.value / _C_SPEC_DRAFT.value)
        _C_TOKENS.inc(produced)
        _G_ACTIVE.set(sum(r is not None for r in self._slots))
        _G_PAGES_FREE.set(self.blocks.free_pages)
        _H_OCC.observe(len(work) / self.max_slots)
        if now > t0:
            _G_TPS.set(produced / (now - t0))
        return True

    # ------------------------------------------------------------------
    # requests and scheduling
    # ------------------------------------------------------------------

    def add_request(self, prompt, max_new_tokens=32, temperature=0.0,
                    eos_token_id=None, priority=0, slo_ms=None,
                    trace_id=None, tenant=None):
        """Queue a prompt (1-D int array / list / tensor). Returns a
        request id; admission happens inside step()/run(), ordered by
        (effective priority, arrival). `trace_id` carries an existing
        trace through the request (else one is minted); `tenant` names its
        owner."""
        return self._submit(prompt, max_new_tokens, temperature,
                            eos_token_id, priority, slo_ms,
                            trace_id=trace_id, tenant=tenant).rid

    def _submit(self, prompt, max_new_tokens, temperature, eos_token_id,
                priority, slo_ms, streaming=False, trace_id=None,
                tenant=None):
        """Shared add_request/stream submission. Returns the GenRequest; a
        streaming submission registers its rid in `_streaming` under the
        same lock, so no concurrent consumer's step can retire and drain
        it before the stream holds it."""
        arr = np.asarray(prompt.cpu() if torch.is_tensor(prompt) else prompt,
                         dtype=np.int64).reshape(-1)
        if arr.size == 0:
            raise ValueError("empty prompt")
        if arr.size + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({arr.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds engine max_seq_len={self.max_seq_len}")
        with self._step_lock:
            rid = self._next_rid
            self._next_rid += 1
            req = GenRequest(rid, arr.astype(np.int32), int(max_new_tokens),
                             float(temperature), eos_token_id,
                             priority=int(priority), slo_ms=slo_ms,
                             order=rid, t_submit=time.perf_counter(),
                             prompt0=int(arr.size),
                             trace=trace_id or new_trace_id(),
                             tenant=sanitize_tenant(tenant))
            self._reqs[rid] = req
            if max_new_tokens <= 0:
                req.done = True
                self._finished[rid] = req
            else:
                self._waiting.append(req)
            _set_queue_depth(self, len(self._waiting))
            if streaming:
                self._streaming.add(rid)
        return req

    def _sorted_waiting(self):
        """Admission order: (effective priority, arrival order)."""
        now = time.perf_counter()
        self._waiting.sort(key=lambda r: (r.effective_priority(now),
                                          r.order))
        return self._waiting

    def _note_first_token(self, req, now):
        """A request's first sampled token: TTFT in ``ttft_s``, the
        histogram, the quantile sketch and the SLO budget check."""
        req.t_first_token = now
        ttft = now - req.t_submit
        self.ttft_s.append(ttft)
        _H_TTFT.observe(ttft)
        _TR.observe("ttft", ttft, tenant=req.tenant)
        _TR.check_slo("ttft", ttft, trace=req.trace, rid=req.rid,
                      target_ms=req.slo_ms, tenant=req.tenant)

    def _retire_if_done(self, req):
        if (len(req.out) >= req.max_new_tokens
                or (req.eos_token_id is not None
                    and req.out and req.out[-1] == req.eos_token_id)):
            if not req.done:
                _C_RETIRE.inc()
                if _OBS_ON[0]:
                    now = time.perf_counter()
                    if req.t_first_token is not None \
                            and req.n_generated > 1:
                        tpot = (now - req.t_first_token) \
                            / (req.n_generated - 1)
                        _TR.observe("tpot", tpot, tenant=req.tenant)
                        _TR.check_slo("tpot", tpot, trace=req.trace,
                                      rid=req.rid, tenant=req.tenant)
                    _TR.observe("e2e", now - req.t_submit,
                                tenant=req.tenant)
                    _TR.check_slo("e2e", now - req.t_submit,
                                  trace=req.trace, rid=req.rid,
                                  tenant=req.tenant)
            req.done = True
            self._finished[req.rid] = req
            if req.slot >= 0:
                self._spec_drop(req.slot)  # draft state keys on the slot
                self._register_live(req)   # the next request with this
                #                            context hits the cache
                self.blocks.release(req.slot)
                self._prefilling.discard(req.slot)
                self._slots[req.slot] = None
                self._n_ctx[req.slot] = 0
                self._active[req.slot] = False
                req.slot = -1

    def _register_live(self, req):
        """Index the full pages covering this slot's prompt+generated
        tokens before its pages are released, capped at the last token
        guaranteed fed through the model. A sequence admitted under an
        older weight epoch never registers: its KV predates the swap."""
        if not self.prefix_cache or req.slot < 0 \
                or req.weight_epoch != self._weight_epoch:
            return
        toks = np.concatenate([req.prompt, np.asarray(req.out, np.int32)])
        n_ok = min(int(self._n_ctx[req.slot]), len(toks) - 1)
        if n_ok >= self.page_size:
            self.blocks.register_prefix(req.slot, toks[:n_ok])

    def _preempt(self, slot):
        """Recompute-style preemption: release the slot's pages and requeue
        the request with its generated tokens folded into the prompt; with
        the prefix cache on its KV is indexed first, so a re-admission
        maps back whatever survived."""
        req = self._slots[slot]
        self.stats["preemptions"] += 1
        _C_PREEMPT.inc()
        self._spec_drop(slot)
        self._register_live(req)
        self.blocks.release(slot)
        self._prefilling.discard(slot)
        self._slots[slot] = None
        self._active[slot] = False
        self._n_ctx[slot] = 0
        req.slot = -1
        out = req.out
        req.out = []
        req.max_new_tokens -= len(out)
        req.prompt = np.concatenate([req.prompt, np.asarray(out, np.int32)])
        req.n_prefilled = req.n_cached = 0
        self._waiting.insert(0, req)
        _set_queue_depth(self, len(self._waiting))

    def _pick_victim(self):
        """Evict the LEAST urgent running sequence: highest effective
        priority class, latest arrival within it."""
        now = time.perf_counter()
        live = [j for j, r in enumerate(self._slots) if r is not None]
        if not live:
            return None
        return max(live, key=lambda j: (
            self._slots[j].effective_priority(now), self._slots[j].order))

    def has_work(self):
        return bool(self._waiting) or any(r is not None for r in self._slots)

    @torch.inference_mode()
    def fork_request(self, rid, max_new_tokens=None, temperature=None,
                     priority=None, slo_ms=None):
        """Fork a RUNNING request into a new request that shares its KV
        pages copy-on-write; the first write into the shared partial tail
        page copies it. Returns the new rid."""
        with self._step_lock:
            parent = self._reqs.get(rid)
            if parent is None or parent.done or parent.slot < 0:
                raise ValueError(f"request {rid} is not running (fork "
                                 "needs a live, admitted sequence)")
            if parent.slot in self._prefilling:
                raise ValueError(f"request {rid} is still prefilling")
            free = [i for i, r in enumerate(self._slots) if r is None]
            if not free:
                raise RuntimeError("no free slot to fork into — raise "
                                   "max_slots or wait for a retirement")
            slot = free[0]
            child_prompt = np.concatenate([parent.prompt,
                                           np.asarray(parent.out, np.int32)])
            n_new = int(parent.max_new_tokens - len(parent.out)
                        if max_new_tokens is None else max_new_tokens)
            # validate BEFORE blocks.fork: a refcount++ with no owning
            # request would never be released
            if len(child_prompt) + n_new > self.max_seq_len:
                raise ValueError(
                    f"fork prompt ({len(child_prompt)}) + max_new_tokens "
                    f"({n_new}) exceeds engine max_seq_len="
                    f"{self.max_seq_len}")
            self.blocks.fork(parent.slot, slot)
            child_rid = self._next_rid
            self._next_rid += 1
            child = GenRequest(
                child_rid, child_prompt, n_new,
                float(parent.temperature if temperature is None
                      else temperature), parent.eos_token_id,
                priority=parent.priority if priority is None else priority,
                slo_ms=slo_ms, order=child_rid,
                t_submit=time.perf_counter(), prompt0=len(child_prompt),
                trace=new_trace_id(), tenant=parent.tenant,
                weight_epoch=parent.weight_epoch)   # shares parent's KV
            child.slot = slot
            child.n_prefilled = len(child.prompt)
            child.n_cached = int(self._n_ctx[parent.slot])
            self._reqs[child_rid] = child
            self._slots[slot] = child
            self._last_tok[slot] = self._last_tok[parent.slot]
            self._n_ctx[slot] = self._n_ctx[parent.slot]
            self._temps[slot] = child.temperature
            self._active[slot] = True
            return child_rid

    # ------------------------------------------------------------------
    # early teardown: deadlines swept at step boundaries, and cancellation
    # ------------------------------------------------------------------

    def _teardown_locked(self, req):
        """Free a request's engine state now (the caller holds
        ``_step_lock``), whatever its phase: mid-prefill, mid-spec, queued
        or decoding. The outcome flag is set before ``done``: a lock-free
        stream reader that sees ``done`` can already read why."""
        if req.slot >= 0:
            self._spec_drop(req.slot)
            self._register_live(req)   # computed KV is still valid KV
            self._flush_cow()          # before any page recycles
            self.blocks.release(req.slot)
            self._prefilling.discard(req.slot)
            self._slots[req.slot] = None
            self._n_ctx[req.slot] = 0
            self._active[req.slot] = False
            req.slot = -1
        if req in self._waiting:
            self._waiting.remove(req)
            _set_queue_depth(self, len(self._waiting))
        req.done = True
        self._finished[req.rid] = req
        self._deadline_rids.discard(req.rid)
        _G_ACTIVE.set(sum(r is not None for r in self._slots))
        _G_PAGES_FREE.set(self.blocks.free_pages)

    def _expire_deadlines(self):
        """Expire every request past its ``deadline_ms`` (the caller holds
        ``_step_lock``; ``step`` sweeps first, so an expiry lands before
        the next dispatch, between prefill chunks and spec bundles too)."""
        now = time.perf_counter()
        for rid in list(self._deadline_rids):
            req = self._reqs.get(rid)
            if req is None or req.done or req.deadline_ms is None:
                self._deadline_rids.discard(rid)
                continue
            if (now - req.t_submit) * 1e3 <= req.deadline_ms:
                continue
            req.deadline_exceeded = True
            self._teardown_locked(req)
            self.stats["deadline_exceeded"] += 1
            _C_DEADLINE.inc()

    def cancel_request(self, rid, reason=None):
        """Tear down a live request within one step. Returns True if it
        was live and is now freed, False for an unknown or finished rid
        (cancel is idempotent). `reason` is kept on the request
        (``cancel_reason``)."""
        with self._urgent_lock():
            req = self._reqs.get(rid)
            if req is None or req.done:
                return False
            req.cancelled = True
            req.cancel_reason = reason
            self._teardown_locked(req)
            self.stats["cancels"] += 1
            _C_CANCEL.inc()
            return True

    def cancel_by_trace(self, trace, reason=None):
        """Cancel the live request carrying this trace id (engine rids are
        local to a process, trace ids are not)."""
        if trace is None:
            return False
        with self._urgent_lock():
            for req in self._reqs.values():
                if req.trace == trace and not req.done:
                    req.cancelled = True
                    req.cancel_reason = reason
                    self._teardown_locked(req)
                    self.stats["cancels"] += 1
                    _C_CANCEL.inc()
                    return True
        return False

    @staticmethod
    def _raise_if_cut(req):
        """A stream's view of early teardown: an expired or cancelled
        request raises, never reads as a normal end."""
        if req.deadline_exceeded:
            raise DeadlineExceededError(
                f"request {req.rid} exceeded deadline_ms="
                f"{req.deadline_ms} after {req.n_generated} tokens")
        if req.cancelled:
            raise RequestCancelledError(
                f"request {req.rid} cancelled after "
                f"{req.n_generated} tokens")

    # ------------------------------------------------------------------
    # streaming front end
    # ------------------------------------------------------------------

    def _bin_finished(self, finished):
        """Hold requests that a stream consumer's step retired for a run()
        caller until its next drain (drop-oldest beyond 1024: an abandoned
        request is never collected)."""
        for r in finished:
            if r.rid not in self._streaming:
                self._results_bin[r.rid] = r
                while len(self._results_bin) > 1024:
                    self._results_bin.popitem(last=False)

    @contextlib.contextmanager
    def _urgent_lock(self):
        """The step lock for admission-critical acquirers (import, stream
        resolve, cancel): step-driving loops yield after their next
        release instead of re-acquiring at once (CPython locks are not
        fair), which bounds a cancel's wait to about one step."""
        with self._urgent_mu:
            self._step_urgent += 1
        try:
            self._step_lock.acquire()
        finally:
            with self._urgent_mu:
                self._step_urgent -= 1
        try:
            yield
        finally:
            self._step_lock.release()

    def _step_or_wait(self, req, n):
        """One step() under the cross-consumer lock for a stream consumer
        racing other step drivers: wait for the lock in short slices and
        return as soon as `req` advanced past `n` tokens (or finished), so
        tokens another thread's step produced are delivered now; skip the
        step when `req` already finished."""
        while not self._step_lock.acquire(timeout=0.02):
            if req.done or req.n_generated > n:
                return
        try:
            if req.done:
                return
            self._bin_finished(self.step())
        finally:
            self._step_lock.release()
            if self._step_urgent:
                time.sleep(0.001)   # lock fairness — see _urgent_lock

    def _follow(self, req, rid, start, pairs):
        """Yield a request's generated tokens from index `start` as steps
        produce them (``(index, token)`` pairs when `pairs`), stepping the
        shared engine meanwhile; raise if it was cut."""
        try:
            n = start
            while True:
                while n < req.n_generated:
                    tok = req.generated_token(n)
                    yield (n, tok) if pairs else tok
                    n += 1
                if req.done:
                    self._raise_if_cut(req)
                    return
                self._step_or_wait(req, n)
        finally:
            self._streaming.discard(rid)
            if req.done:
                self._reqs.pop(rid, None)   # see _drain_finished

    def stream(self, prompt, max_new_tokens=32, temperature=0.0,
               eos_token_id=None, priority=0, slo_ms=None, trace_id=None,
               tenant=None):
        """Submit a request and yield its generated token ids as they are
        produced. Safe from several threads: every consumer steps the
        shared engine under one lock, and a token any thread's step
        produced reaches every stream. Tokens are read through the
        request's generated sequence, so a preemption drops nothing."""
        req = self._submit(prompt, max_new_tokens, temperature,
                           eos_token_id, priority, slo_ms, streaming=True,
                           trace_id=trace_id, tenant=tenant)
        yield from self._follow(req, req.rid, 0, pairs=False)

    async def astream(self, prompt, max_new_tokens=32, temperature=0.0,
                      eos_token_id=None, priority=0, slo_ms=None,
                      trace_id=None, tenant=None):
        """Async stream(): an async generator of token ids whose engine
        steps run in a worker thread, so the event loop stays free."""
        import asyncio
        req = self._submit(prompt, max_new_tokens, temperature,
                           eos_token_id, priority, slo_ms, streaming=True,
                           trace_id=trace_id, tenant=tenant)
        rid = req.rid
        try:
            n = 0
            while True:
                while n < req.n_generated:
                    yield req.generated_token(n)
                    n += 1
                if req.done:
                    self._raise_if_cut(req)
                    return
                await asyncio.to_thread(self._step_or_wait, req, n)
        finally:
            self._streaming.discard(rid)
            if req.done:
                self._reqs.pop(rid, None)   # see _drain_finished

    def stream_request(self, rid, start=0):
        """Yield ``(index, token)`` of a resident request's generated
        sequence from index `start`: the exactly-once resume surface (a
        consumer that delivered `start` tokens, perhaps from another
        engine, sees none again and misses none). The request is resolved
        now, under the step lock, not at the first next()."""
        with self._urgent_lock():
            req = self._reqs.get(rid) or self._finished.get(rid)
            if req is None:
                raise KeyError(f"request {rid} is not resident")
            self._streaming.add(rid)
        return self._follow(req, rid, int(start), pairs=True)

    # ------------------------------------------------------------------
    # sequence checkpoint/restore: a snapshot re-prefills, through the
    # prefix cache where its pages survive, or maps the KV pages that ride
    # it (``with_kv``)
    # ------------------------------------------------------------------

    def export_request(self, rid, with_kv=False):
        """The snapshot (``make_sequence_snapshot``) of a resident
        request, taken under the step lock: verified tokens only, never
        drafts. ``with_kv=True`` adds the request's written KV pages under
        ``snap["kv"]`` (``{"meta", "payload"}``, kvpages/v1), which an
        importer maps instead of re-prefilling. Raises KeyError for an
        unknown rid."""
        with self._step_lock:
            req = self._reqs.get(rid) or self._finished.get(rid)
            if req is None:
                raise KeyError(f"request {rid} is not resident "
                               "(already drained?)")
            return self._export_locked(req, with_kv=with_kv)

    def _export_locked(self, req, with_kv=False):
        now = time.perf_counter()
        snap = make_sequence_snapshot(
            [int(t) for t in req.prompt] + [int(t) for t in req.out],
            prompt0=int(req.prompt0),
            remaining=int(req.max_new_tokens) - len(req.out),
            temperature=float(req.temperature),
            eos_token_id=None if req.eos_token_id is None
            else int(req.eos_token_id),
            priority=req.priority, slo_ms=req.slo_ms, done=req.done,
            # clocks as ages: perf_counter epochs differ across processes
            age_s=max(0.0, now - req.t_submit),
            ttft_s=(None if req.t_first_token is None
                    else max(0.0, req.t_first_token - req.t_submit)),
            trace=req.trace, tenant=req.tenant,
            deadline_ms=req.deadline_ms)
        if with_kv:
            kv = self._export_kv_of(req)
            if kv is not None:
                snap["kv"] = kv
        return snap

    def _export_kv_of(self, req):
        """Serialize a live request's written KV pages straight off its
        block table: the FULL pages of the tokens guaranteed written (the
        last sampled token's KV lands only at the next dispatch, and a
        chunk's post-EOS positions hold discarded rows: the cap of
        ``_register_live``). Returns ``{"meta", "payload"}``, or None
        when nothing is page-complete or the request was admitted under
        an older weight epoch (its KV predates the swap; stamping it with
        the current tag would pass it off as the new weights')."""
        if req.slot < 0 or req.weight_epoch != self._weight_epoch:
            return None
        n_written = req.n_prefilled if req.slot in self._prefilling \
            else int(self._n_ctx[req.slot])
        n_ok = min(n_written, len(req.prompt) + len(req.out) - 1)
        n_full = n_ok // self.page_size
        if n_full <= 0:
            return None
        self._flush_cow()     # a queued CoW dst must hold its content
        pids = [int(p) for p in self.blocks.block_tables[req.slot, :n_full]]
        toks = ([int(t) for t in req.prompt]
                + [int(t) for t in req.out])[:n_full * self.page_size]
        meta, payload = self._pack(pids, toks, req.trace, req.tenant)
        _EVENTS.record("engine_kv_export", rid=req.rid, trace=req.trace,
                       pages=n_full, nbytes=len(payload))
        return {"meta": meta, "payload": payload}

    def _pack(self, pids, toks, trace, tenant):
        """Gather and serialize pages for export, timing each part into
        ``stats`` (``kv_gather_s``, ``kv_pack_s``) and booking the
        counters."""
        from ..serving.kv_transfer import pack_pages
        t0 = time.perf_counter()
        k_rows, v_rows, k_sc, v_sc = self._gather_pages(pids)
        t1 = time.perf_counter()
        meta, payload = pack_pages(k_rows, v_rows, toks, self.page_size,
                                   weights_tag=self._weights_tag,
                                   k_scales=k_sc, v_scales=v_sc,
                                   shards=self.kv_shards)
        st = self.stats
        st["kv_gather_s"] += t1 - t0
        st["kv_pack_s"] += time.perf_counter() - t1
        st["kv_pages_out"] += len(pids)
        st["kv_bytes_out"] += len(payload)
        _C_KV_EXP.inc(len(pids))
        _C_KV_OUT_B.inc(len(payload))
        _LEDGER.on_bytes(len(payload), trace, tenant, "out")
        return meta, payload

    def export_kv_pages(self, tokens, trace=None):
        """Serialize the cached KV pages covering the longest INDEXED
        prefix of `tokens` (the prefill -> decode handoff: a prefill
        replica's finished sequence leaves its pages in the prefix index).
        Non-destructive. Returns ``(meta, payload)`` or None when no full
        page is indexed."""
        if not self.prefix_cache:
            return None
        toks = [int(t) for t in np.asarray(
            tokens.cpu() if torch.is_tensor(tokens) else tokens).reshape(-1)]
        with self._step_lock:
            self._flush_cow()
            pids = []
            for h, parent, ptoks in _prefix_chain(toks, self.page_size):
                entry = self.blocks._index.get(h)
                if entry is None or entry[1] != parent \
                        or entry[2] != ptoks:
                    break
                pids.append(entry[0])
            if not pids:
                return None
            meta, payload = self._pack(
                pids, toks[:len(pids) * self.page_size], trace, None)
            _EVENTS.record("engine_kv_export", trace=trace,
                           pages=len(pids), nbytes=len(payload))
            return meta, payload

    def import_kv_pages(self, meta, payload, trace=None):
        """Map a transferred page batch into this engine's pools: every
        page whose chain hash is not indexed yet is adopted (refcount 0,
        cached: matchable and reclaimable) and its content uploaded in one
        program, so the next ``match_prefix`` over the same tokens maps
        them instead of prefilling. Returns the pages newly mapped: 0 when
        the batch comes from other weights (``weights_tag``), another kv
        dtype (int8 against float: KV is never transcoded) or another
        shard count, each recorded as ``engine_kv_import_skipped``.
        Raises ValueError when the geometry does not fit the pools."""
        with self._step_lock:
            return self._import_kv_locked(meta, payload, trace=trace)

    def _check_kv_meta(self, meta):
        shards = (meta.get("shards") or {}).get("count", 1)
        shape = self._pool_shape            # (n_pages, page, H, D)
        return (meta.get("page_size") == self.page_size
                and meta.get("n_layers") == self._n_layers
                and meta.get("n_kv_heads") == shape[2]
                and meta.get("head_dim") == shape[3]
                and (meta.get("dtype") == "int8")
                == (self.kv_dtype == "int8")
                and int(shards) == self.kv_shards)

    def _import_kv_locked(self, meta, payload, trace=None):
        if not self.prefix_cache:
            return 0
        int8 = self.kv_dtype == "int8"
        refusal = None
        if meta.get("weights_tag", "init") != self._weights_tag:
            refusal = ("weights_tag", meta.get("weights_tag"),
                       self._weights_tag)
        elif (meta.get("dtype") == "int8") != int8:
            refusal = ("kv_dtype", meta.get("dtype"),
                       "int8" if int8 else "float")
        elif int((meta.get("shards") or {}).get("count", 1)) \
                != self.kv_shards:
            refusal = ("kv_shards",
                       int((meta.get("shards") or {}).get("count", 1)),
                       self.kv_shards)
        if refusal is not None:
            # the importer re-prefills, which is always right
            _EVENTS.record("engine_kv_import_skipped", trace=trace,
                           reason=refusal[0], theirs=refusal[1],
                           ours=refusal[2])
            return 0
        if not self._check_kv_meta(meta):
            raise ValueError(
                "KV page batch does not fit this engine: "
                f"meta={{page_size: {meta.get('page_size')}, layers: "
                f"{meta.get('n_layers')}, kv_heads: "
                f"{meta.get('n_kv_heads')}, head_dim: "
                f"{meta.get('head_dim')}}} vs pool "
                f"page_size={self.page_size} shape="
                f"{self._pool_shape} x{self._n_layers}")
        from ..serving.kv_transfer import unpack_pages, unpack_scales
        t0 = time.perf_counter()
        k_rows, v_rows = unpack_pages(meta, payload,
                                      expect_shards=self.kv_shards)
        k_sc, v_sc = unpack_scales(meta) if int8 else (None, None)
        t1 = time.perf_counter()
        pids, cols = [], []
        for i, (h, parent, ptoks) in enumerate(
                _prefix_chain(meta["tokens"], self.page_size)):
            try:
                pid = self.blocks.adopt_page(h, parent, ptoks)
            except RuntimeError:
                break       # pool exhausted: the adopted prefix stands
            if pid is None:
                continue    # already resident here
            pids.append(pid)
            cols.append(i)
        if pids:
            self._flush_cow()
            if len(cols) < k_rows.shape[1]:   # some pages were resident
                idx = torch.as_tensor(cols)
                k_rows = k_rows.index_select(1, idx)
                v_rows = v_rows.index_select(1, idx)
                if k_sc is not None:
                    k_sc, v_sc = k_sc[:, cols], v_sc[:, cols]
            self._upload_pages(pids, k_rows, v_rows, k_sc, v_sc)
            _C_KV_IMP.inc(len(pids))
            _C_KV_IN_B.inc(len(payload))
            _LEDGER.on_bytes(len(payload), trace, None, "in")
            _G_PAGES_FREE.set(self.blocks.free_pages)
        st = self.stats
        st["kv_unpack_s"] += t1 - t0
        st["kv_upload_s"] += time.perf_counter() - t1
        st["kv_pages_in"] += len(pids)
        st["kv_bytes_in"] += len(payload)
        _EVENTS.record("engine_kv_import", trace=trace,
                       pages=len(pids), offered=meta["n_pages"],
                       nbytes=len(payload))
        return len(pids)

    def _spill_page(self, pid, h, parent, toks):
        """BlockManager eviction hook: serialize ONE evicted refcount-0
        page into the prefix store (keyed by its chain hash and this
        engine's weights tag) before its page id is reused."""
        from ..serving.kv_transfer import pack_pages
        k_rows, v_rows, k_sc, v_sc = self._gather_pages([pid])
        meta, payload = pack_pages(k_rows, v_rows, list(toks),
                                   self.page_size,
                                   weights_tag=self._weights_tag,
                                   k_scales=k_sc, v_scales=v_sc,
                                   shards=self.kv_shards)
        meta["parent"] = parent     # refill checks the whole chain link
        self.prefix_store.put(h, meta, payload)
        _C_KV_SPILL.inc()
        _LEDGER.on_bytes(len(payload), None, None, "spill")
        _EVENTS.record("engine_kv_spill", pages=1, nbytes=len(payload))

    def _refill_prefix(self, req):
        """Admission-time prefix-store refill: walk the prompt's chain and,
        where the index misses, take the page from the prefix store (RAM
        tier, then the fleet tier), so the ``match_prefix`` that follows
        hits it as if it had never been evicted (or as if this replica had
        prefilled it). Stops at the first miss; returns pages refilled."""
        from ..serving.kv_transfer import unpack_pages, unpack_scales
        int8 = self.kv_dtype == "int8"
        fetched, rows_k, rows_v, rows_ks, rows_vs = [], [], [], [], []
        for h, parent, ptoks in _prefix_chain(req.prompt[:len(req.prompt)
                                                         - 1],
                                              self.page_size):
            entry = self.blocks._index.get(h)
            if entry is not None and entry[1] == parent \
                    and entry[2] == ptoks:
                continue                # resident: nothing to refill
            if entry is not None:
                break                   # hash collision: chain unusable
            got = self.prefix_store.get(h, self._weights_tag)
            if got is None:
                break
            meta, payload = got
            if meta.get("tokens") != list(ptoks) \
                    or meta.get("parent", parent) != parent \
                    or not self._check_kv_meta(meta) \
                    or meta.get("n_pages") != 1:
                break                   # stale or foreign entry: a miss
            try:
                k1, v1 = unpack_pages(meta, payload,
                                      expect_shards=self.kv_shards)
                ks1, vs1 = unpack_scales(meta) if int8 else (None, None)
            except ValueError as e:
                # a corrupted spilled page (crc32, byte count): the chain
                # walk stops and the prefill recomputes from here
                _EVENTS.record("engine_kv_refill_rejected", rid=req.rid,
                               trace=req.trace, chain_hash=int(h),
                               error=str(e)[:160])
                break
            try:
                pid = self.blocks.adopt_page(h, parent, ptoks)
            except RuntimeError:
                break
            if pid is None:
                break
            _LEDGER.on_bytes(len(payload), req.trace, req.tenant, "upload")
            fetched.append(pid)
            rows_k.append(k1[:, 0])
            rows_v.append(v1[:, 0])
            if int8:
                rows_ks.append(ks1[:, 0])
                rows_vs.append(vs1[:, 0])
        if not fetched:
            return 0
        self._flush_cow()
        self._upload_pages(
            fetched, torch.stack(rows_k, dim=1), torch.stack(rows_v, dim=1),
            np.stack(rows_ks, axis=1) if int8 else None,
            np.stack(rows_vs, axis=1) if int8 else None)
        _C_KV_REFILL.inc(len(fetched))
        _G_PAGES_FREE.set(self.blocks.free_pages)
        _EVENTS.record("engine_kv_refill", rid=req.rid, trace=req.trace,
                       pages=len(fetched))
        return len(fetched)

    def find_rid_by_trace(self, trace):
        """The resident request carrying `trace`. Raises KeyError when
        none does."""
        if not trace:
            raise KeyError("empty trace id")
        with self._step_lock:
            for table in (self._reqs, self._finished):
                for rid, req in table.items():
                    if req.trace == trace:
                        return rid
        raise KeyError(f"no resident request carries trace {trace!r}")

    def remove_request(self, rid, with_kv=False):
        """Export a request's snapshot AND evict it (a planned migration):
        pages released, slot freed, queues cleaned. Returns the snapshot;
        a lingering stream of it ends. ``with_kv=True`` carries the
        computed KV pages along (the drain handoff that moves the bytes
        instead of recomputing them on the destination)."""
        with self._step_lock:
            req = self._reqs.get(rid)
            if req is None:
                raise KeyError(f"request {rid} is not resident")
            snap = self._export_locked(req, with_kv=with_kv)
            if req.slot >= 0:
                self._spec_drop(req.slot)
                self._register_live(req)    # surviving pages stay
                self._flush_cow()           # mappable for a re-prefill
                self.blocks.release(req.slot)
                self._prefilling.discard(req.slot)
                self._slots[req.slot] = None
                self._active[req.slot] = False
                self._n_ctx[req.slot] = 0
                req.slot = -1
            if req in self._waiting:
                self._waiting.remove(req)
                _set_queue_depth(self, len(self._waiting))
            req.done = True
            self._reqs.pop(rid, None)
            self._finished.pop(rid, None)
            self._streaming.discard(rid)
            self._deadline_rids.discard(rid)
        return snap

    def import_request(self, snap, streaming=False):
        """Queue a snapshot (from this engine, another, or the JAX
        engine's ``export_request``). The generated sequence (prompt0 and
        the delivered tokens) is kept, so ``stream_request(rid,
        start=cursor)`` resumes exactly once; clocks and the deadline
        continue from the original submission. KV pages riding the
        snapshot (``snap["kv"]``) are mapped before the request queues, so
        its admission maps them instead of prefilling; a transfer that
        fails to map degrades to the re-prefill (recorded as
        ``engine_kv_import_failed``). Returns the new rid."""
        toks = np.asarray(snap["tokens"], np.int64).reshape(-1)
        if toks.size == 0:
            raise ValueError("empty sequence snapshot")
        remaining = int(snap["remaining"])
        if toks.size + max(remaining, 0) > self.max_seq_len:
            raise ValueError(
                f"snapshot ({toks.size} tokens + {remaining} remaining) "
                f"exceeds engine max_seq_len={self.max_seq_len}")
        with self._urgent_lock():
            kv = snap.get("kv")
            if kv:
                try:
                    self._import_kv_locked(kv["meta"], kv["payload"],
                                           trace=snap.get("trace"))
                except Exception as e:  # noqa: BLE001 — a malformed
                    #                     transfer must never fail a
                    #                     request a re-prefill serves
                    _EVENTS.record("engine_kv_import_failed",
                                   trace=snap.get("trace"),
                                   error=f"{type(e).__name__}: "
                                         f"{str(e)[:160]}")
            rid = self._next_rid
            self._next_rid += 1
            now = time.perf_counter()
            req = GenRequest(
                rid, toks.astype(np.int32), max(remaining, 0),
                float(snap.get("temperature", 0.0)),
                snap.get("eos_token_id"),
                priority=int(snap.get("priority", 0)),
                slo_ms=snap.get("slo_ms"), order=rid,
                t_submit=now - float(snap.get("age_s", 0.0)),
                prompt0=int(snap.get("prompt0", toks.size)),
                trace=snap.get("trace") or new_trace_id(),
                tenant=sanitize_tenant(snap.get("tenant")),
                deadline_ms=snap.get("deadline_ms"))
            if snap.get("ttft_s") is not None:
                req.t_first_token = req.t_submit + float(snap["ttft_s"])
            self._reqs[rid] = req
            done = bool(snap.get("done")) or remaining <= 0 or (
                req.eos_token_id is not None and req.n_generated > 0
                and int(toks[-1]) == req.eos_token_id)
            if done:
                # nothing left to compute: resident for replay through
                # stream_request, retired at once
                req.done = True
                self._finished[rid] = req
            else:
                self._waiting.append(req)
                if req.deadline_ms is not None:
                    self._deadline_rids.add(rid)
            _set_queue_depth(self, len(self._waiting))
            if streaming:
                self._streaming.add(rid)
        return rid

    # ------------------------------------------------------------------
    # hot weight swap
    # ------------------------------------------------------------------

    def swap_weights(self, loader, tag=None):
        """Run `loader()` (which changes the model's parameters in place,
        e.g. a checkpoint load) between steps, under the step lock and
        ``torch.no_grad()`` (the parameters are trainable leaves; an
        in-place copy into one raises under autograd). Then the prefix
        index is dropped (cached KV is the old weights'), the drafter's
        state and the acceptance EWMAs are reset, and the weight epoch
        and tag move on: in-flight sequences keep their KV and continue
        under the new weights, but never register it. Returns what the
        loader returns."""
        with self._step_lock:
            with torch.no_grad():
                out = loader()
                self._weights_loaded()
            # an in-place load keeps every address the programs captured;
            # a moved parameter drops them (rebuilt at their next use)
            self._programs.revalidate()
            old_tag = self._weights_tag
            self.blocks.invalidate_index()
            if self._spec is not None:
                self._spec.invalidate()
                self._spec_state.clear()
            self._weight_epoch += 1
            self._weights_tag = str(tag) if tag is not None \
                else f"epoch{self._weight_epoch}"
            if self.prefix_store is not None:
                # the old weights' spilled pages are dead to this engine
                # (the tag refuses them): drop the RAM tier now, the
                # fleet tier's TTL sweep takes the rest
                self.prefix_store.invalidate(old_tag)
            _G_PAGES_FREE.set(self.blocks.free_pages)
            _EVENTS.record("engine_weight_swap",
                           live=sum(r is not None for r in self._slots),
                           waiting=len(self._waiting))
        return out

    @torch.inference_mode()
    def step(self):
        """Admit waiting requests into free slots (mapping cached prefix
        pages): cold prompts that fit one chunk through one dense batched
        prefill, the rest into the ragged program. Then advance prefills
        through the ragged program (with the decode batch riding the same
        launch in mixed mode), then run one decode chunk for the pool.
        Returns the requests that finished.

        Callers hold ``_step_lock`` (``run``, the streams)."""
        if self.step_delay_s:
            time.sleep(self.step_delay_s)   # the brownout hook
        if self._deadline_rids:
            # before admitting or dispatching: a blown deadline must not
            # claim a slot or ride one dispatch further
            self._expire_deadlines()
        free = [i for i, r in enumerate(self._slots) if r is None]
        if free and self._waiting:
            self._sorted_waiting()
        dense = []
        for slot in free:
            if not self._waiting:
                break
            req = self._waiting.pop(0)
            if self.prefix_store is not None:
                # re-adopt spilled or peer-prefilled pages before the match
                # walks the chain, so they read as a plain prefix hit
                self._refill_prefix(req)
            pids, n_cached = self.blocks.match_prefix(
                req.prompt, max_tokens=len(req.prompt) - 1)
            if self.prefix_cache:
                if n_cached:
                    self.stats["prefix_hits"] += 1
                    self.stats["prefix_hit_tokens"] += n_cached
                    _C_PFX_HIT.inc()
                    _C_PFX_TOK.inc(n_cached)
                else:
                    self.stats["prefix_misses"] += 1
                    _C_PFX_MISS.inc()
            req.n_cached = req.n_prefilled = n_cached
            req.slot = slot
            req.weight_epoch = self._weight_epoch
            self._slots[slot] = req
            self._temps[slot] = req.temperature
            self._active[slot] = False
            self.blocks.map_shared(slot, [int(p) for p in pids])
            if n_cached == 0 and (self.prefill_chunk is None or
                                  len(req.prompt) <= self.prefill_chunk):
                dense.append((req, slot))     # batched dense prefill
            else:
                self._prefilling.add(slot)    # ragged suffix/chunk path
        _set_queue_depth(self, len(self._waiting))
        if dense:
            self._admit(dense)

        prefilling = [s for s in sorted(self._prefilling)
                      if self._slots[s] is not None]
        self._prefilling = set(prefilling)
        if prefilling:
            decode_now = [i for i, r in enumerate(self._slots)
                          if r is not None and i not in self._prefilling]
            if self.mixed_step and decode_now:
                self._ragged_step(prefilling, decode_now)
                return self._drain_finished()
            self._ragged_step(prefilling, [])

        active = [i for i, r in enumerate(self._slots)
                  if r is not None and i not in self._prefilling]
        if not active:
            return self._drain_finished()
        # speculative decoding: the draft-and-verify dispatch replaces the
        # plain chunk; False (sampling pool, no drafts, drafter error)
        # falls through to the chunk
        if self._spec is not None and self._spec_step(active):
            return self._drain_finished()
        # as many steps as every running sequence can still take, a power
        # of two; a mid-chunk EOS just discards that slot's tail tokens
        k_max = min(self._slots[i].max_new_tokens - len(self._slots[i].out)
                    for i in active)
        k = 1
        while k * 2 <= min(k_max, self.decode_chunk):
            k *= 2
        active = self._grow_for_chunk(active, k)
        self._flush_cow()   # CoW copies land before the chunk writes
        if active:
            self._decode_chunk(active, k)
        return self._drain_finished()

    def _drain_finished(self):
        out, self._finished = self._finished, {}
        for rid in out:
            # a stream-owned rid stays resident until its stream lets go
            if rid not in self._streaming:
                self._reqs.pop(rid, None)
        return list(out.values())

    def run(self):
        """Drive step() until every queued request finishes. Returns
        {rid: np.ndarray(prompt + generated)} for the requests no live
        stream consumes. Steps under the streams' lock, so run() and
        streams may share the engine."""
        results = {}

        def collect(reqs):
            for req in reqs:
                if req.rid not in self._streaming:
                    results[req.rid] = np.concatenate(
                        [req.prompt, np.asarray(req.out, np.int32)])

        while self.has_work():
            with self._step_lock:
                finished = self.step()
                while self._results_bin:   # retired by a stream's step
                    finished.append(
                        self._results_bin.popitem(last=False)[1])
            collect(finished)
            if self._step_urgent:
                time.sleep(0.001)   # lock fairness — see _urgent_lock
        with self._step_lock:
            collect(self._drain_finished())   # max_new_tokens <= 0
            while self._results_bin:
                collect([self._results_bin.popitem(last=False)[1]])
        return results

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 seed=None, eos_token_id=None):
        """Generate for a rectangular batch [B, S]; returns a
        [B, S + max_new_tokens] np.ndarray in input order, rows that
        stopped early at eos_token_id right-padded with the eos id."""
        ids = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                         else input_ids)
        if ids.ndim == 1:
            ids = ids[None]
        if seed is not None:
            self.reseed(seed)
        rids = [self.add_request(row, max_new_tokens, temperature,
                                 eos_token_id) for row in ids]
        results = self.run()
        width = ids.shape[1] + max_new_tokens
        pad = eos_token_id if eos_token_id is not None else 0
        out = np.full((len(rids), width), pad, ids.dtype)
        for i, r in enumerate(rids):
            row = results[r]
            out[i, :len(row)] = row
        return out
