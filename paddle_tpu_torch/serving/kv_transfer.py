"""KV-page transfer plane: page serialization + the
fleet-tier prefix store.

The engine's KV pages never left the device before this module: failover
deliberately re-prefilled because a snapshot of host-side primitives is
portable and a device buffer is not. But the chain-hashed page identity
the prefix cache is built on (``inference.engine._prefix_chain`` —
``hash((parent_hash, page_tokens))``) makes every FULL page
content-addressable ACROSS processes: two replicas holding the same
weights that prefill the same token path hold bit-identical KV for it.
So a page's bytes can move once instead of being recomputed per replica
(the minimal-transfer framing of memory-efficient array redistribution,
PAPERS.md arxiv 2112.01075), and the receiver can verify what it got by
recomputing the chain from the tokens that ride the metadata.

Two pieces:

- **the codec** (``pack_pages``/``unpack_pages``): dtype-aware
  serialization of a page batch ``[n_layers, 2(kv), n_pages, page_size,
  n_kv_heads, head_dim]`` to one contiguous payload + a JSON-able meta
  dict (schema ``kvpages/v1``). float32 ships raw; bfloat16 ships as its
  uint16 bit pattern (bit-exact round trip, half the bytes of upcasting):
  the port reads it off a torch tensor through ``view(torch.int16)``
  and back through ``torch.frombuffer``, never through a float and with
  no numpy bfloat16 type, so its payload bytes and meta are the JAX
  package's for the same pages;
  int8 pages ship their raw codes with the per-(layer, page)
  dequant scales riding the ``scales`` slot the schema reserved — the
  wire format needed no second revision, exactly as planned.
  The tokens covered by the pages ride the meta — the importer
  re-derives the chain hashes from THE one definition and content-checks
  every page before serving it.

- **PrefixStore**: the spill tier for refcount-0 pages the BlockManager's
  LRU cached pool evicts. A host-RAM ``OrderedDict`` (bounded bytes,
  LRU) fronts an optional FileStore-backed FLEET tier, so a system
  prompt prefilled once on any replica becomes a fleet-wide prefix-cache
  hit — the prefix-affinity router already knows how to exploit it.
  Consistency: every entry is keyed under the producer's ``weights_tag``
  (bumped by hot weight swap); a reader only accepts entries whose tag
  matches its own, so KV from an older checkpoint can never be mapped
  into a post-swap prefill. Spill ownership uses ``compare_set``
  set-if-absent (one winner per chain page; losers drop their copy —
  the content is identical anyway, the verb just avoids rewrite storms),
  and ``gc()`` TTL-expires the namespace via ``sweep_expired``.
"""

from __future__ import annotations

import json
import threading
import time
import zlib
from collections import OrderedDict

import warnings

import numpy as np
import torch

from ..observability.metrics import REGISTRY as _REG
from ..observability.costs import LEDGER as _LEDGER

__all__ = ["pack_pages", "unpack_pages", "unpack_scales", "PrefixStore",
           "KV_SCHEMA"]

KV_SCHEMA = "kvpages/v1"

_C_STORE_PUT = _REG.counter("kv_store_pages_put_total",
                            "pages spilled into the prefix store")
_C_STORE_HIT = _REG.counter("kv_store_hits_total",
                            "prefix-store lookups that returned a page")
_C_STORE_MISS = _REG.counter("kv_store_misses_total",
                             "prefix-store lookups that found nothing")
_C_STORE_FLEET_HIT = _REG.counter(
    "kv_store_fleet_hits_total",
    "prefix-store hits served by the FLEET tier (spilled by a peer "
    "process, not this one) — the cross-replica payoff")
_C_STORE_EVICT = _REG.counter(
    "kv_store_ram_evictions_total",
    "host-RAM tier LRU evictions (bytes budget pressure)")
_C_STORE_WDROP = _REG.counter(
    "kv_store_fleet_writes_dropped_total",
    "fleet-tier spill writes dropped because the async write queue "
    "was full (the RAM tier still holds the page)")
_G_STORE_BYTES = _REG.gauge("kv_store_ram_bytes",
                            "bytes resident in the host-RAM tier")
_C_CRC_FAIL = _REG.counter(
    "kv_store_checksum_failures_total",
    "KV page payloads rejected by the crc32 integrity check (a spilled "
    "or transferred page whose bytes rotted; the importer re-prefills, "
    "never maps the aliased KV)")


_DTYPES = {
    "float32": (np.float32, torch.float32),
    # wire type uint16: the bf16 bit pattern, bit-exact both ways
    "bfloat16": (np.uint16, torch.bfloat16),
    # int8 KV pages: raw codes on the wire, per-(layer, page)
    # dequant scales in the meta's `scales` slot — the slot kvpages/v1
    # reserved, so no schema rev
    "int8": (np.int8, torch.int8),
}

_TORCH_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.int8: "int8"}


def _wire(rows, dtype=None):
    """(dtype name, C-contiguous numpy array of the wire type) of a page
    batch: a torch tensor (any device; bf16 read as its int16 bits), or a
    numpy array (float32, int8, a 2-byte bfloat16 array from another
    package, or uint16 bits with ``dtype="bfloat16"``)."""
    if torch.is_tensor(rows):
        name = _TORCH_NAMES.get(rows.dtype)
        if name is None:
            raise ValueError(
                f"KV page dtype {rows.dtype} is not serializable "
                f"(kvpages/v1 speaks {sorted(_DTYPES)})")
        t = rows.detach().contiguous().cpu()
        if name == "bfloat16":
            t = t.view(torch.int16)
        return name, np.ascontiguousarray(t.numpy()).view(_DTYPES[name][0])
    arr = np.ascontiguousarray(rows)
    name = str(arr.dtype) if dtype is None else str(dtype)
    if name not in _DTYPES:
        raise ValueError(
            f"KV page dtype {name!r} is not serializable "
            f"(kvpages/v1 speaks {sorted(_DTYPES)})")
    wire = _DTYPES[name][0]
    if arr.dtype.itemsize != np.dtype(wire).itemsize:
        raise ValueError(f"a {arr.dtype} array cannot carry {name} pages")
    return name, arr.view(wire)


def _scale_table(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else t


def _check_scales(dtype, scales, n_layers, n_pages, who):
    """The scales slot's reject matrix: int8 pages REQUIRE a
    per-(layer, page) scale table for both k and v; float pages must
    not carry one (a scale table on f32/bf16 pages means the exporter
    and importer disagree about what the bytes are)."""
    if dtype != "int8":
        if scales is not None:
            raise ValueError(
                f"{who}: scales present but pages are {dtype} — the "
                f"scales slot only rides int8 pages")
        return None
    if not isinstance(scales, dict) or "k" not in scales \
            or "v" not in scales:
        raise ValueError(
            f"{who}: int8 pages need scales {{'k': ..., 'v': ...}} "
            f"per-(layer, page) tables; got {type(scales).__name__}")
    out = {}
    for side in ("k", "v"):
        arr = np.asarray(scales[side], np.float32)
        if arr.shape != (n_layers, n_pages):
            raise ValueError(
                f"{who}: {side}-scales shape {arr.shape} != "
                f"({n_layers}, {n_pages}) (per-layer, per-page)")
        out[side] = arr
    return out


def pack_pages(k_rows, v_rows, tokens, page_size, weights_tag="init",
               k_scales=None, v_scales=None, shards=1, dtype=None):
    """Serialize a page batch. `k_rows`/`v_rows`: torch tensors or numpy
    arrays ``[n_layers, n_pages, page_size, n_kv_heads, head_dim]``
    (bf16, f32, or int8; numpy bf16 pages as their uint16 bits with
    ``dtype="bfloat16"``); `tokens`: the token ids the pages cover, in order —
    ``n_pages * page_size`` of them (full pages only; the chain hash is
    only defined for full pages). int8 pages require `k_scales` /
    `v_scales` ``[n_layers, n_pages]`` f32 dequant tables (they ride
    the meta's ``scales`` slot). Returns ``(meta, payload)`` with
    `payload` one contiguous ``bytes`` (k then v, C order) and `meta`
    JSON-able.

    ``shards``: a mesh-sharded engine owns its kv heads in
    per-shard ranges, so its exports frame the payload as ``shards``
    CONTIGUOUS per-shard streams — stream ``i`` is shard ``i``'s head
    slice, k then v, each stream individually crc'd and offset-indexed
    in the meta's ``shards`` block. The framing is an OWNERSHIP
    statement, not a transport detail: an importer whose own shard
    count differs must refuse (never re-split a stream laid out for a
    different topology — see the reject matrix in ``unpack_pages`` /
    the engine's ``_check_kv_meta``). ``shards=1`` is byte-for-byte
    the unsharded wire (no ``shards`` key at all), so every existing blob
    and peer keeps decoding. Scales are per-(layer, page) — heads
    share them — so the scale tables ride the meta once, unsharded."""
    dtype, k_rows = _wire(k_rows, dtype)
    v_dtype, v_rows = _wire(v_rows, dtype)
    if v_dtype != dtype:
        raise ValueError(f"k pages are {dtype}, v pages {v_dtype}")
    if k_rows.shape != v_rows.shape or k_rows.ndim != 5:
        raise ValueError(f"bad page batch shapes: k{k_rows.shape} "
                         f"v{v_rows.shape}")
    n_layers, n_pages, pg, n_heads, head_dim = k_rows.shape
    if pg != page_size:
        raise ValueError(f"page batch page_size {pg} != {page_size}")
    shards = int(shards)
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if shards > 1 and n_heads % shards:
        raise ValueError(
            f"{n_heads} kv heads do not split into {shards} shards — "
            f"per-shard streams need heads-local ownership")
    tokens = [int(t) for t in tokens]
    if len(tokens) != n_pages * page_size:
        raise ValueError(
            f"{len(tokens)} tokens do not cover {n_pages} full pages "
            f"of {page_size}")
    scales = None
    if k_scales is not None or v_scales is not None:
        scales = {"k": _scale_table(k_scales), "v": _scale_table(v_scales)}
    checked = _check_scales(dtype, scales, n_layers, n_pages,
                            "pack_pages")
    shard_block = None
    if shards > 1:
        hps = n_heads // shards
        streams, parts, off = [], [], 0
        for i in range(shards):
            sl = slice(i * hps, (i + 1) * hps)
            part = b"".join(
                (np.ascontiguousarray(k_rows[:, :, :, sl]).data,
                 np.ascontiguousarray(v_rows[:, :, :, sl]).data))
            streams.append({"index": i, "offset": off,
                            "nbytes": len(part),
                            "crc32": zlib.crc32(part) & 0xFFFFFFFF})
            parts.append(part)
            off += len(part)
        payload = b"".join(parts)
        shard_block = {"count": shards, "heads_per_shard": hps,
                       "streams": streams}
    else:
        # one copy into the payload (the JAX package's k + v bytes)
        payload = b"".join((k_rows.data, v_rows.data))
    meta = {
        "schema": KV_SCHEMA,
        "dtype": dtype,
        "layout": "l.p.s.h.d",       # layer, page, slot, kv-head, dim
        "n_layers": int(n_layers), "n_pages": int(n_pages),
        "page_size": int(page_size),
        "n_kv_heads": int(n_heads), "head_dim": int(head_dim),
        "tokens": tokens,
        "weights_tag": str(weights_tag),
        "nbytes": len(payload),
        # payload integrity: the chain-hash identity proves
        # WHICH tokens the pages claim to cover, but says nothing about
        # the page BYTES — a bit flipped in a spilled blob (disk rot,
        # torn fleet-store write) would silently alias wrong KV into a
        # matching prefill. crc32 rides the meta; importers verify
        # before mapping. Readers tolerate its absence (older blobs
        # age out of the store via gc()).
        "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
        # int8 pages: per-(layer, page) dequant scales (f32 exact over
        # JSON — the float64 decimal repr round-trips every f32)
        "scales": None if checked is None else
        {side: checked[side].astype(np.float64).tolist()
         for side in ("k", "v")},
    }
    if shard_block is not None:
        meta["shards"] = shard_block
    return meta, payload


def _shard_frames(meta, payload, shape):
    """Validate the ``shards`` block against the geometry and the
    payload bytes (the per-shard leg of the reject matrix), returning
    the parsed stream list. Every violation is a refusal — a framing
    the receiver cannot prove is a framing it must not map."""
    sh = meta["shards"]
    count = int(sh.get("count", 0))
    hps = int(sh.get("heads_per_shard", 0))
    streams = sh.get("streams") or []
    if count < 2 or hps * count != shape[3] or len(streams) != count:
        raise ValueError(
            f"KV shards block does not frame the geometry: count="
            f"{count} x heads_per_shard={hps} vs {shape[3]} kv heads, "
            f"{len(streams)} streams")
    per = (len(payload) // count)
    off = 0
    for i, s in enumerate(streams):
        if int(s.get("index", -1)) != i or int(s["offset"]) != off \
                or int(s["nbytes"]) != per:
            raise ValueError(
                f"KV shard stream {i} misframed: index="
                f"{s.get('index')} offset={s.get('offset')}/{off} "
                f"nbytes={s.get('nbytes')}/{per}")
        part = payload[off:off + per]
        if "crc32" in s and (zlib.crc32(part) & 0xFFFFFFFF) \
                != int(s["crc32"]):
            _C_CRC_FAIL.inc()
            raise ValueError(
                f"KV shard stream {i} checksum mismatch — per-shard "
                "page bytes corrupted; refusing to map aliased KV")
        off += per
    return count, hps


def _frombuffer(buf, dtype, shape):
    """A CPU tensor over `buf`'s bytes (no copy; read-only use)."""
    with warnings.catch_warnings():
        # the payload is immutable bytes: nothing writes through the view
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)


def unpack_pages(meta, payload, expect_shards=None):
    """Inverse of ``pack_pages``: returns ``(k_rows, v_rows)`` CPU torch
    tensors ``[n_layers, n_pages, page_size, n_kv_heads, head_dim]`` in
    the original dtype (bf16 read from its uint16 wire form bit-exactly,
    as ``torch.bfloat16`` over the same bytes). Validates schema, dtype,
    and byte count. The tensors view `payload`: read them, or copy.

    A sharded payload (meta carries a ``shards`` block) reassembles the
    per-shard head streams back into full-head arrays AFTER verifying
    each stream's framing and crc. ``expect_shards`` arms the reject
    matrix at the codec layer: pass the importer's own shard count and
    a mismatch REFUSES (ValueError) instead of re-splitting — a stream
    layout is the exporter's head-ownership statement and only a
    same-count peer may adopt it (``None`` skips the topology check,
    for tooling that only inspects content)."""
    if meta.get("schema") != KV_SCHEMA:
        raise ValueError(f"unknown KV page schema {meta.get('schema')!r}"
                         f" (this build speaks {KV_SCHEMA})")
    dtype = meta["dtype"]
    if dtype not in _DTYPES:
        raise ValueError(f"unknown KV page dtype {dtype!r}")
    _check_scales(dtype, meta.get("scales"), meta["n_layers"],
                  meta["n_pages"], "unpack_pages")
    wire, tdtype = _DTYPES[dtype]
    shape = (meta["n_layers"], meta["n_pages"], meta["page_size"],
             meta["n_kv_heads"], meta["head_dim"])
    n = int(np.prod(shape))
    want = 2 * n * np.dtype(wire).itemsize
    if len(payload) != want:
        raise ValueError(f"KV payload is {len(payload)} bytes, "
                         f"expected {want} for {shape} x2 {dtype}")
    shard_count = int((meta.get("shards") or {}).get("count", 1))
    if expect_shards is not None and shard_count != int(expect_shards):
        raise ValueError(
            f"KV page stream is framed for {shard_count} shard(s) but "
            f"this importer owns {int(expect_shards)} — refusing to "
            "re-split a peer topology's head streams (re-prefill "
            "instead)")
    if "crc32" in meta:
        got = zlib.crc32(payload) & 0xFFFFFFFF
        if got != int(meta["crc32"]):
            _C_CRC_FAIL.inc()
            raise ValueError(
                f"KV payload checksum mismatch: crc32 {got:#010x} != "
                f"recorded {int(meta['crc32']):#010x} — page bytes "
                "corrupted in the store/transfer; refusing to map "
                "aliased KV (importer re-prefills)")
    if shard_count > 1:
        count, hps = _shard_frames(meta, payload, shape)
        per = len(payload) // count
        half = per // 2
        sshape = shape[:3] + (hps, shape[4])
        ks, vs = [], []
        view = memoryview(payload)
        for i in range(count):
            part = view[i * per:(i + 1) * per]
            ks.append(_frombuffer(part[:half], tdtype, sshape))
            vs.append(_frombuffer(part[half:], tdtype, sshape))
        return torch.cat(ks, dim=3), torch.cat(vs, dim=3)
    flat = _frombuffer(payload, tdtype, (2 * n,))
    return flat[:n].reshape(shape), flat[n:].reshape(shape)


def unpack_scales(meta):
    """(k_scales, v_scales) ``[n_layers, n_pages]`` f32 from a packed
    meta, or ``(None, None)`` for float pages. Runs the same reject
    matrix as unpack_pages (shape / dtype-pairing checks)."""
    checked = _check_scales(meta["dtype"], meta.get("scales"),
                            meta["n_layers"], meta["n_pages"],
                            "unpack_scales")
    if checked is None:
        return None, None
    return checked["k"], checked["v"]


def _blob(meta, payload):
    return json.dumps(meta).encode() + b"\n" + payload


def _unblob(blob):
    head, _, payload = blob.partition(b"\n")
    return json.loads(head), payload


class PrefixStore:
    """Two-tier spill store for evicted prefix-cache pages, keyed by the
    deterministic chain hash (an int — PYTHONHASHSEED-free by the
    prefix-chain construction, so every process computes the same key).

    ``put``/``get`` move ONE page at a time (eviction is per page;
    refill walks the chain page by page and stops at the first miss,
    exactly like ``match_prefix``). Entries are single-page
    ``pack_pages`` blobs; the tokens in the meta are the importer's
    content check."""

    def __init__(self, store=None, capacity_bytes=256 << 20, ttl_s=600.0,
                 namespace="serve/kv", write_queue=256):
        """store: optional FileStore-like fleet tier (None = host-RAM
        only, the single-replica spill tier). capacity_bytes bounds the
        RAM tier (LRU). ttl_s drives ``gc()`` on the fleet tier.
        write_queue bounds the ASYNC fleet-write queue: ``put`` runs on
        the engine's allocation hot path (under its step lock), so the
        fleet tier's fsync + CAS-lock write happens on a background
        thread — only the cheap RAM insert is synchronous; a full queue
        drops the fleet write (accounted), never stalls allocation."""
        self._store = store
        self._ram = OrderedDict()     # key -> blob bytes
        self._bytes = 0
        self._cap = int(capacity_bytes)
        self.ttl_s = float(ttl_s)
        self._ns = namespace.rstrip("/")
        self._lock = threading.Lock()
        self._wq_cap = int(write_queue)
        self._wq = None               # lazy: only fleet-tier puts spawn
        self._pending = 0             # the writer thread

    def _key(self, chain_hash, weights_tag):
        return f"{self._ns}/{weights_tag}/{chain_hash:x}" \
            if chain_hash >= 0 else \
            f"{self._ns}/{weights_tag}/n{-chain_hash:x}"

    def __len__(self):
        return len(self._ram)

    def put(self, chain_hash, meta, payload):
        """Spill one page. Key = (namespace, meta's weights_tag, chain
        hash). RAM tier always takes it (LRU under the bytes budget);
        the fleet tier takes it via compare_set set-if-absent — first
        spiller owns the key, peers spilling the same content lose the
        race and write nothing."""
        blob = _blob(meta, payload)
        key = self._key(int(chain_hash), meta.get("weights_tag", "init"))
        with self._lock:
            old = self._ram.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._ram[key] = blob
            self._bytes += len(blob)
            while self._bytes > self._cap and len(self._ram) > 1:
                _, dropped = self._ram.popitem(last=False)
                self._bytes -= len(dropped)
                _C_STORE_EVICT.inc()
            _G_STORE_BYTES.set(self._bytes)
        _C_STORE_PUT.inc()
        # cost ledger: store traffic has no owning trace at
        # this layer (a spilled page may serve many future requests) —
        # the bytes land in the aggregate dir=store_put bucket
        _LEDGER.on_bytes(len(blob), None, None, "store_put")
        if self._store is not None:
            self._enqueue_fleet_write(key, blob)

    def _enqueue_fleet_write(self, key, blob):
        """Queue the fleet-tier write for the background writer —
        ``put`` runs under the engine step lock, and the FileStore
        write is an fsync plus a CAS lock-file spin that must not stall
        allocation. Drop-oldest-caller semantics: a full queue counts
        the drop (the RAM tier still holds the page; a peer's own
        spill, or the next eviction cycle, can land it later)."""
        import queue
        with self._lock:
            if self._wq is None:
                self._wq = queue.Queue(maxsize=self._wq_cap)
                threading.Thread(target=self._fleet_writer,
                                 daemon=True,
                                 name="kv-prefix-store-writer").start()
            try:
                self._wq.put_nowait((key, blob))
                self._pending += 1
            except queue.Full:
                _C_STORE_WDROP.inc()

    def _fleet_writer(self):
        while True:
            key, blob = self._wq.get()
            try:
                cas = getattr(self._store, "compare_set", None)
                if cas is not None:
                    cas(key, b"", blob)       # set-if-absent ownership
                else:
                    self._store.set(key, blob)
            except Exception:  # noqa: BLE001 — fleet tier best-effort:
                pass           # the RAM tier still holds the page
            finally:
                with self._lock:
                    self._pending -= 1

    def flush(self, timeout=10.0):
        """Block until queued fleet-tier writes drained (tests, and a
        drain choreography that wants spills durable before a replica
        dies). True when drained, False on timeout."""
        deadline = time.monotonic() + float(timeout)
        while True:
            with self._lock:
                if self._pending <= 0:
                    return True
            if time.monotonic() > deadline:
                return False
            time.sleep(0.005)

    def get(self, chain_hash, weights_tag="init"):
        """Fetch one spilled page: ``(meta, payload)`` or None. A fleet-
        tier hit back-fills the RAM tier (the next sharer on this
        replica is a RAM hit)."""
        key = self._key(int(chain_hash), weights_tag)
        with self._lock:
            blob = self._ram.get(key)
            if blob is not None:
                self._ram.move_to_end(key)
        if blob is None and self._store is not None:
            try:
                blob = self._store.get(key)
            except KeyError:
                blob = None
            except Exception:  # noqa: BLE001 — store outage reads as
                blob = None    # a miss, never an error on the hot path
            if blob is not None:
                _C_STORE_FLEET_HIT.inc()
                with self._lock:
                    if key not in self._ram:
                        self._ram[key] = blob
                        self._bytes += len(blob)
                        while self._bytes > self._cap \
                                and len(self._ram) > 1:
                            _, dropped = self._ram.popitem(last=False)
                            self._bytes -= len(dropped)
                            _C_STORE_EVICT.inc()
                        _G_STORE_BYTES.set(self._bytes)
        if blob is None:
            _C_STORE_MISS.inc()
            return None
        _C_STORE_HIT.inc()
        _LEDGER.on_bytes(len(blob), None, None, "store_get")
        meta, payload = _unblob(blob)
        return meta, payload

    def invalidate(self, weights_tag=None):
        """Drop RAM-tier entries (all, or one weights_tag's) — hot swap
        calls this with the OLD tag; fleet-tier entries age out via
        ``gc()`` (their tag no longer matches any reader, so they are
        dead weight, not a correctness hazard)."""
        with self._lock:
            if weights_tag is None:
                self._ram.clear()
                self._bytes = 0
            else:
                pre = f"{self._ns}/{weights_tag}/"
                for key in [k for k in self._ram if k.startswith(pre)]:
                    self._bytes -= len(self._ram.pop(key))
            _G_STORE_BYTES.set(self._bytes)

    def gc(self, ttl_s=None):
        """TTL-expire the fleet tier's namespace (sweep_expired verb).
        Returns keys removed (0 with no fleet tier)."""
        if self._store is None:
            return 0
        sweep = getattr(self._store, "sweep_expired", None)
        if sweep is None:
            return 0
        try:
            return sweep(self._ns + "/",
                         self.ttl_s if ttl_s is None else float(ttl_s))
        except Exception:  # noqa: BLE001 — GC is best-effort
            return 0
