"""Speculative decoding drafters: the counterpart of
``paddle_tpu/inference/speculative.py``.

Decode reads the whole model and KV working set to produce one token per
sequence. With speculative decoding the engine drafts up to K candidate
tokens a slot cheaply, then the TARGET model verifies all of them in ONE
ragged dispatch (each decode row becomes a window of q_len = 1 + K tokens,
``model.paged_verify``), and the engine commits the longest prefix the
greedy argmax confirms plus the bonus token. Greedy output equals plain
decode's: the verify argmax is plain decode's argmax, and drafts only
decide how many of those argmaxes one dispatch commits.

Two drafters behind one contract:

- ``NgramDrafter``: prompt lookup. Per slot, the last n-gram of the
  committed sequence is matched against its own history and the tokens
  that followed its most recent earlier occurrence are proposed. Host
  only, no device state.
- ``DraftModelDrafter``: a (small) draft model served through the same
  paged contract with its OWN pools: a private ``GenerationEngine``
  supplies pools, block manager and launch helpers, and the drafter drives
  its slot state directly. Per ``propose``: one ragged catch-up dispatch
  (the tokens the target committed since the last round; its greedy next
  token is draft 1), then one (k - 1)-step greedy decode for the rest.

A drafter never changes the output, only how many tokens a dispatch
commits. Drafter state is local to the engine: ``export_request`` carries
verified tokens only, and ``swap_weights`` invalidates all draft state.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Drafter", "NgramDrafter", "DraftModelDrafter", "make_drafter",
           "spec_decode_from_env"]


class Drafter:
    """The contract the engine's spec step drives.

    ``propose(live, k)`` gets ``{slot: committed tokens (np.int32)}`` for
    every slot the engine wants drafts for (slots in a collapse cooldown
    are left out) and returns ``{slot: [<= k draft token ids]}``; a
    missing slot or an empty list means no opinion, and the slot rides the
    verify dispatch as a plain q_len = 1 row. Called under the engine's
    step lock; per-slot state may key on the slot id.

    ``history_window``: how many tail tokens of the committed sequence
    ``propose`` reads (None: all of it), so that the engine copies no more
    than that per slot and dispatch.
    """

    name = "base"
    history_window = None

    def bind(self, engine):
        """Called once when an engine adopts the drafter."""

    def propose(self, live, k):
        raise NotImplementedError

    def observe(self, slot, accepted, drafted):
        """Per-slot verify outcome (accepted of drafted); optional."""

    def drop_slot(self, slot):
        """The slot retired, was preempted or moved: forget its state."""

    def invalidate(self):
        """Weight swap: every piece of draft state is stale."""


def _common_prefix(a, b):
    """Length of the common prefix of two 1-D int arrays."""
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.flatnonzero(np.asarray(a[:n]) != np.asarray(b[:n]))
    return int(neq[0]) if neq.size else n


class NgramDrafter(Drafter):
    """Prompt-lookup drafting: propose the continuation of the most recent
    earlier occurrence of the sequence's current suffix n-gram (longest
    gram first), within the last ``max_window`` tokens."""

    name = "ngram"

    def __init__(self, ngram=3, min_gram=1, max_window=2048):
        if ngram < 1 or min_gram < 1 or min_gram > ngram:
            raise ValueError(f"need 1 <= min_gram <= ngram, got "
                             f"({min_gram}, {ngram})")
        self.ngram = int(ngram)
        self.min_gram = int(min_gram)
        # the scan is O(window) per slot and dispatch: bounding it keeps a
        # long context from paying a quadratic lookup tax
        self.max_window = int(max_window)
        self.history_window = self.max_window

    def propose(self, live, k):
        out = {}
        for slot, toks in live.items():
            t = np.asarray(toks)[-self.max_window:]
            n = int(t.size)
            for g in range(min(self.ngram, n - 1), self.min_gram - 1, -1):
                pat = t[n - g:]
                win = np.lib.stride_tricks.sliding_window_view(t, g)
                hits = np.flatnonzero((win == pat).all(axis=1))
                hits = hits[hits < n - g]   # not the suffix itself: at
                #                             least one continuation token
                if hits.size:
                    j = int(hits[-1])       # the most recent occurrence
                    d = t[j + g: j + g + int(k)]
                    if d.size:
                        out[slot] = [int(x) for x in d]
                    break
        return out


class DraftModelDrafter(Drafter):
    """Drafting with a draft model through the paged contract
    (``paged_spec``, ``paged_prefill_ragged``, ``paged_decode``).

    ``bind`` builds a private ``GenerationEngine`` over the draft model,
    sized to the target engine's slots and pages (``propose`` keys its
    pools by the target's slot ids), pinned spec-off and without prefix
    cache, chunking or mixed steps. ``kv_dtype`` is its pools' format
    (None: as ``PADDLE_TPU_KV_INT8`` says, as in the JAX package; "int8":
    int8 pools beside an int8 target). ``propose``:

    1. reconcile: a slot's valid draft KV is the common prefix of what the
       drafter fed last round and what the target committed (rejected
       drafts only lower the valid length; the stale KV past it is masked
       by position and overwritten by the next write);
    2. catch-up and draft 1: ONE ragged dispatch feeds each slot's
       committed tokens not yet seen (the last committed token is fed
       again every round, so q_len >= 1) and returns the greedy next
       token;
    3. drafts 2..k: ONE (k - 1)-step greedy decode, whose pages are
       assigned before it reads the block table.
    """

    name = "draft_model"

    def __init__(self, draft_model, kv_dtype=None):
        for need in ("paged_spec", "paged_prefill_ragged", "paged_decode"):
            if not hasattr(draft_model, need):
                raise ValueError(
                    f"draft model lacks the paged contract ({need}) — "
                    "DraftModelDrafter reuses paged_spec/paged_decode/"
                    "paged_prefill_ragged with its own block pool")
        self.model = draft_model
        self.kv_dtype = kv_dtype
        self._eng = None
        self._hist = {}     # slot -> tokens fed (np.int32, the KV's tokens)
        self._ctx = {}      # slot -> positions with draft KV written

    def bind(self, engine):
        from .engine import GenerationEngine
        spec = self.model.paged_spec()
        # positions up to len(committed) - 1 + (k - 1) get draft KV
        want = engine.max_seq_len + int(engine.spec_k) + 1
        self._eng = GenerationEngine(
            self.model, max_slots=engine.max_slots,
            page_size=engine.page_size,
            max_seq_len=min(want, spec["max_len"]), kv_dtype=self.kv_dtype,
            prefix_cache=False, prefill_chunk=None, mixed_step=False,
            spec_decode=False,   # never a drafter inside the drafter, even
            seed=0)              # with PADDLE_TPU_SPEC_DECODE set

    def propose(self, live, k):
        eng = self._eng
        if eng is None:
            raise RuntimeError("DraftModelDrafter.propose before bind()")
        k = int(k)
        rows = []
        for slot, toks in sorted(live.items()):
            toks = np.asarray(toks, np.int32)
            n = int(toks.size)
            if n + k - 1 >= eng.max_seq_len or n < 1:
                self.drop_slot(slot)    # the draft pool cannot hold it
                continue
            ctx = min(self._ctx.get(slot, 0),
                      _common_prefix(self._hist.get(slot, toks[:0]), toks))
            rows.append((slot, toks, ctx))
        if not rows:
            return {}

        # catch-up + draft 1: one ragged dispatch
        ragged = []
        for slot, toks, ctx in rows:
            m = int(toks.size) - ctx            # >= 1: last token re-fed
            pids, offs = eng.blocks.assign(slot, ctx, m)
            ragged.append((slot, toks[ctx:], ctx, pids, offs))
        arrays = eng._ragged_arrays(ragged)
        d1 = eng._ragged_launch(*arrays, np.zeros(len(arrays[0]),
                                                  np.float32))
        drafts = {slot: [int(d1[i])] for i, (slot, _, _) in enumerate(rows)}

        # drafts 2..k: one greedy decode of k - 1 steps
        if k > 1:
            b = eng.max_slots
            tokens = np.zeros(b, np.int64)
            positions = np.zeros(b, np.int64)
            active = np.zeros(b, bool)
            for i, (slot, toks, _) in enumerate(rows):
                # pages before the launch reads the block table
                eng.blocks.assign(slot, int(toks.size), k - 1)
                tokens[slot] = d1[i]
                positions[slot] = toks.size
                active[slot] = True
            out = eng._decode_launch(tokens, positions, active, k - 1)
            for slot, _, _ in rows:
                drafts[slot].extend(int(t) for t in out[:, slot])

        for slot, toks, _ in rows:
            d = drafts[slot]
            # the KV now covers committed + drafts[:-1] (the last draft was
            # never fed); hist records each written position's token
            self._hist[slot] = np.concatenate([toks, np.asarray(d, np.int32)])
            self._ctx[slot] = int(toks.size) + len(d) - 1
        return drafts

    def drop_slot(self, slot):
        if slot in self._hist:
            self._hist.pop(slot, None)
            self._ctx.pop(slot, None)
            if self._eng is not None:
                self._eng.blocks.release(slot)

    def invalidate(self):
        """Forget every slot's draft KV (a weight swap); the private
        engine's programs stay unless a parameter moved."""
        for slot in list(self._hist):
            self.drop_slot(slot)
        if self._eng is not None:
            self._eng._programs.revalidate()


def spec_decode_from_env(value):
    """Parse a ``PADDLE_TPU_SPEC_DECODE`` value: "", "0", "off", "false",
    "none" and "no" mean off (None); anything else is returned lowered for
    ``make_drafter`` ("1"/"ngram", "ngram:<n>"). The draft-model drafter
    needs a live model and cannot be named here."""
    v = (value or "").strip().lower()
    if v in ("", "0", "off", "false", "none", "no"):
        return None
    return v


def make_drafter(spec):
    """A ``spec_decode=`` value as a Drafter: a Drafter passes through;
    True, "1", "ngram", "true" and "on" give an ``NgramDrafter``;
    "ngram:<n>" sets its gram length. Anything else raises ValueError."""
    if isinstance(spec, Drafter):
        return spec
    if spec is True:
        return NgramDrafter()
    if isinstance(spec, str):
        v = spec.strip().lower()
        if v in ("1", "ngram", "true", "on"):
            return NgramDrafter()
        if v.startswith("ngram:"):
            return NgramDrafter(ngram=int(v.split(":", 1)[1]))
    raise ValueError(
        f"unknown spec_decode value {spec!r} — pass a Drafter instance, "
        "'ngram', or 'ngram:<n>'")
