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

What differs in this slice:

- no JIT: the JAX engine's compiled programs are the step programs of
  ``programs.py`` — CUDA graphs on the card, captured once per bucket
  (decode (steps, sampling), dense admission (c, s_pad, sampling), ragged
  (c, s_pad, sampling), verify (c, s_pad), CoW copy (n)) and replayed
  over static buffers, counted in the JAX engine's trace counters
  (``decode_trace_count``, ``prefill_trace_count``,
  ``ragged_trace_count``, ``spec_trace_count``, ``copy_trace_count``);
  on the CPU the same programs run eagerly. The dense and ragged batches
  are padded to power-of-two (rows, tokens) buckets and decode chunks to
  power-of-two lengths, as in JAX, so the programs stay few. Pools are
  updated in place under ``torch.inference_mode()`` (``step``,
  ``fork_request`` and every program): the model's parameters are
  trainable, and a pool written inside an autograd graph would hold that
  graph across steps. The engine has no KV page upload program (the
  JAX ``_build_upload``): KV import comes with the fleet plane.
- the JAX engine's prefix store, KV-page export/import (``with_kv=``, a
  snapshot's ``kv``) and metrics registry are not served yet: asking for
  one raises NotImplementedError naming the slice that brings it.
  ``engine.stats`` holds what the registry's counters hold in JAX for the
  parts served here (the spec counters among them).

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
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..quantization import page_quant
from .programs import StepPrograms


class PagedGenerationMixin:
    """Engine front door shared by the causal-LM model classes."""

    def get_engine(self, max_slots=4, page_size=16, **kw):
        """Cached GenerationEngine for this model, one per pool shape; a
        small LRU, since each engine owns a full KV pool on the device."""
        cache = self.__dict__.setdefault("_engines", OrderedDict())
        sig = (max_slots, page_size, tuple(sorted(kw.items())))
        eng = cache.pop(sig, None)
        if eng is None:
            if len(cache) >= 4:
                for key in list(cache):     # oldest-first: evict an IDLE
                    if not cache[key].has_work():   # pool
                        del cache[key]
                        break
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


def new_trace_id():
    """16-hex-character opaque request trace id, unique across processes
    (the JAX package's ``observability.tracing.new_trace_id`` with
    telemetry on)."""
    return os.urandom(8).hex()


def sanitize_tenant(tenant):
    """Canonical tenant label: characters other than alphanumerics and
    ``._-`` become ``_``, at most 64 of them; None stays None (the JAX
    package's ``observability.tracing.sanitize_tenant``)."""
    if tenant is None:
        return None
    out = "".join(c if (c.isalnum() or c in "._-") else "_"
                  for c in str(tenant))
    return out[:64] or "_"


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

    @property
    def free_pages(self):
        return len(self._free) + len(self._cached)

    def _take_page(self):
        if self._free:
            pid = self._free.pop()
        elif self._cached:
            pid, h = self._cached.popitem(last=False)   # evict LRU
            self._index.pop(h, None)
            self._hash_of.pop(pid, None)
            self.evictions += 1
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


def _unsupported(what, slice_name):
    return NotImplementedError(
        f"{what} is not served by this slice of paddle_tpu_torch; it comes "
        f"with the {slice_name} slice")


class GenerationEngine:
    """Fixed-capacity continuous-batching engine for one model, on the
    model's device."""

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
        if prefix_store is not None:
            raise _unsupported("prefix_store", "fleet plane")
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
        shape = (n_pages, self.page_size, spec["n_kv_heads"],
                 spec["head_dim"])
        self.k_pages = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(spec["n_layers"])]
        self.v_pages = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(spec["n_layers"])]
        # int8 pools: per-(layer, page) scale rows. Ones, not zeros: a page
        # is attendable before its opening write lands (masked by position,
        # but the dequant still runs)
        self.k_scales = self.v_scales = None
        if self.kv_dtype == "int8":
            self.k_scales = [torch.ones(n_pages, dtype=torch.float32,
                                        device=self.device)
                             for _ in range(spec["n_layers"])]
            self.v_scales = [torch.ones(n_pages, dtype=torch.float32,
                                        device=self.device)
                             for _ in range(spec["n_layers"])]
        pool_bytes = sum(t.numel() * t.element_size()
                         for t in (*self.k_pages, *self.v_pages,
                                   *(self.k_scales or ()),
                                   *(self.v_scales or ())))
        self.blocks = BlockManager(n_pages, self.page_size,
                                   self._pages_per_slot, self.max_slots,
                                   prefix_cache=prefix_cache)
        self.prefix_cache = bool(prefix_cache)
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
        self._weights_tag = "init"
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
                      "kv_pool_bytes": pool_bytes}
        self.ttft_s = deque(maxlen=4096)   # first-token latency per request
        model.eval()

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
            else:
                try:
                    self._spec = make_drafter(spec_decode)
                except ValueError:
                    if not from_env:
                        raise
                    # an ambient typo serves plain, never fails startup
                    self.spec_env_ignored = (str(spec_decode)[:40],
                                             "unknown_value")
        if self._spec is not None:
            self._spec.bind(self)

    def reseed(self, seed):
        self._gen.manual_seed(int(seed))

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

    def _copy_program(self, inputs):
        """The CoW copy step: dst pages take the src pages' content in
        every pool; int8 scale rows ride along (a copied page keeps its
        frozen scale)."""
        src, dst = inputs["src"], inputs["dst"]
        for pool in (*self.k_pages, *self.v_pages, *(self.k_scales or ()),
                     *(self.v_scales or ())):
            pool[dst] = pool[src]

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
                req.t_first_token = now
                self.ttft_s.append(now - req.t_submit)
            self.blocks.register_prefix(slot, req.prompt)
            self._retire_if_done(req)

    def _prefill_program(self, inputs):
        """The dense admission step: ``paged_prefill``, the pool write
        (``_write_prefill``) and each row's first token."""
        logits, ks, vs = self.model.paged_prefill(inputs["ids"],
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
        n_layers, c, s_pad = ks.shape[:3]
        n_pg = page_ids.shape[1]
        pad = n_pg * self.page_size - s_pad
        flat = page_ids.reshape(-1)
        for kv, pools, scales in ((ks, self.k_pages, self.k_scales),
                                  (vs, self.v_pages, self.v_scales)):
            if pad:
                kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, pad))
            pages = kv.reshape(n_layers, c * n_pg, self.page_size,
                               *kv.shape[3:])
            if scales is not None:
                pages, page_scales = page_quant.quantize_pages(pages)
            for li, pool in enumerate(pools):
                pool[flat] = pages[li].to(pool.dtype)
                if scales is not None:
                    scales[li][flat] = page_scales[li]

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
        toks_np = self._ragged_launch(*arrays, temps)
        now = time.perf_counter()

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
                        req.t_first_token = now
                        self.ttft_s.append(now - req.t_submit)
                    self.blocks.register_prefix(slot, req.prompt)
                    self._retire_if_done(req)
            else:
                req.out.append(tok)
                self.stats["mixed_decode_tokens"] += 1
                self._last_tok[slot] = tok
                self._n_ctx[slot] += 1
                self._retire_if_done(req)

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
        logits = self.model.paged_prefill_ragged(
            *self._ragged_model_args(inputs), **self._scales())[0]
        return sample_tokens(logits, inputs.get("temps"), self._gen)

    def _verify_program(self, inputs):
        """The verify step: ``paged_verify`` and the greedy argmax at every
        position."""
        logits = self.model.paged_verify(
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
        toks_np = self._decode_launch(self._last_tok, self._n_ctx,
                                      self._active, k, temps)

        for i in active:
            req = self._slots[i]
            self._n_ctx[i] += k
            self._last_tok[i] = int(toks_np[k - 1, i])
            for t in range(k):
                req.out.append(int(toks_np[t, i]))
                self.stats["decode_tokens"] += 1
                if (req.eos_token_id is not None
                        and req.out[-1] == req.eos_token_id):
                    break              # tail of the chunk is discarded
            self._retire_if_done(req)

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
            logits = self.model.paged_decode(
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
        toks_np = self._verify_launch(*arrays)
        self.stats["spec_rows"] += len(work)

        st_all = self.stats
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
                st_all["spec_tokens"] += 1
                if (req.eos_token_id is not None
                        and req.out[-1] == req.eos_token_id):
                    break          # the tail of the bundle is discarded
                if len(req.out) >= req.max_new_tokens:
                    break
            self._last_tok[slot] = req.out[-1]
            self._n_ctx[slot] = len(req.prompt) + len(req.out) - 1
            if m:
                st_all["spec_draft_tokens"] += m
                st_all["spec_accepted_tokens"] += a
                st = self._spec_state.setdefault(
                    slot, {"ewma": 1.0, "cool": 0})
                st["ewma"] = 0.7 * st["ewma"] + 0.3 * (a / m)
                if a < m:
                    st_all["spec_rollbacks"] += 1
                    # rejected positions' pages go back now; stale KV in
                    # kept pages sits past the context and is masked by
                    # position, then overwritten by the next write
                    self.blocks.trim(slot, int(self._n_ctx[slot]) + 1)
                if st["ewma"] < self.spec_min_accept:
                    st["cool"] = self.spec_cooldown
                self._spec.observe(slot, a, m)
            self._retire_if_done(req)
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
            if streaming:
                self._streaming.add(rid)
        return req

    def _sorted_waiting(self):
        """Admission order: (effective priority, arrival order)."""
        now = time.perf_counter()
        self._waiting.sort(key=lambda r: (r.effective_priority(now),
                                          r.order))
        return self._waiting

    def _retire_if_done(self, req):
        if (len(req.out) >= req.max_new_tokens
                or (req.eos_token_id is not None
                    and req.out and req.out[-1] == req.eos_token_id)):
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
        req.done = True
        self._finished[req.rid] = req
        self._deadline_rids.discard(req.rid)

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
    # sequence checkpoint/restore (no KV: a restored sequence re-prefills,
    # through the prefix cache where its pages survive)
    # ------------------------------------------------------------------

    def export_request(self, rid, with_kv=False):
        """The snapshot (``make_sequence_snapshot``) of a resident
        request, taken under the step lock: verified tokens only, never
        drafts. Raises KeyError for an unknown rid."""
        if with_kv:
            raise _unsupported("export_request(with_kv=True) (KV pages on "
                               "the kvpages/v1 wire)", "fleet plane")
        with self._step_lock:
            req = self._reqs.get(rid) or self._finished.get(rid)
            if req is None:
                raise KeyError(f"request {rid} is not resident "
                               "(already drained?)")
            return self._export_locked(req)

    def _export_locked(self, req):
        now = time.perf_counter()
        return make_sequence_snapshot(
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
        a lingering stream of it ends."""
        if with_kv:
            raise _unsupported("remove_request(with_kv=True) (KV pages on "
                               "the kvpages/v1 wire)", "fleet plane")
        with self._step_lock:
            req = self._reqs.get(rid)
            if req is None:
                raise KeyError(f"request {rid} is not resident")
            snap = self._export_locked(req)
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
        continue from the original submission. Returns the new rid."""
        if snap.get("kv"):
            raise _unsupported("a snapshot's KV pages (kvpages/v1)",
                               "fleet plane")
        toks = np.asarray(snap["tokens"], np.int64).reshape(-1)
        if toks.size == 0:
            raise ValueError("empty sequence snapshot")
        remaining = int(snap["remaining"])
        if toks.size + max(remaining, 0) > self.max_seq_len:
            raise ValueError(
                f"snapshot ({toks.size} tokens + {remaining} remaining) "
                f"exceeds engine max_seq_len={self.max_seq_len}")
        with self._urgent_lock():
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
            # an in-place load keeps every address the programs captured;
            # a moved parameter drops them (rebuilt at their next use)
            self._programs.revalidate()
            self.blocks.invalidate_index()
            if self._spec is not None:
                self._spec.invalidate()
                self._spec_state.clear()
            self._weight_epoch += 1
            self._weights_tag = str(tag) if tag is not None \
                else f"epoch{self._weight_epoch}"
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
            pids, n_cached = self.blocks.match_prefix(
                req.prompt, max_tokens=len(req.prompt) - 1)
            if self.prefix_cache:
                if n_cached:
                    self.stats["prefix_hits"] += 1
                    self.stats["prefix_hit_tokens"] += n_cached
                else:
                    self.stats["prefix_misses"] += 1
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
