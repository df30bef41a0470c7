"""Spawn-mode DataLoader worker: the counterpart of
``paddle_tpu/io/_shm_worker.py`` (ref: python/paddle/io/dataloader/
worker.py ``_worker_loop`` + fluid/imperative/data_loader.cc shm queue).

A worker collates batches wid, wid + nw, ... and hands each over as a
``multiprocessing.shared_memory`` block holding every numpy array of the
batch back to back, plus a small picklable spec (the batch's structure,
each array's offset, shape and type; other leaves inline) sent on a
queue. The parent maps the block, copies the arrays out and unlinks it
(``unpack``). Workers are spawned, never forked (see ``DataLoader``), so
this module imports only the stdlib and numpy at module scope; a torch
tensor leaf is handed over as a numpy array and comes back as one.
"""

from __future__ import annotations

import traceback
from multiprocessing import shared_memory

import numpy as np

_ALIGN = 64


def _leaves(obj, arrays):
    """obj with every array leaf replaced by ("__arr__", index)."""
    if isinstance(obj, np.ndarray):
        arrays.append(np.ascontiguousarray(obj))
        return ("__arr__", len(arrays) - 1)
    if hasattr(obj, "detach") and hasattr(obj, "numpy"):     # torch
        return _leaves(obj.detach().cpu().numpy(), arrays)
    if isinstance(obj, tuple):
        return ("__tuple__", [_leaves(o, arrays) for o in obj])
    if isinstance(obj, list):
        return [_leaves(o, arrays) for o in obj]
    if isinstance(obj, dict):
        return {k: _leaves(v, arrays) for k, v in obj.items()}
    return obj


def pack(batch):
    """(shm name or None, spec) of a batch, its arrays in one block."""
    arrays = []
    spec = _leaves(batch, arrays)
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // _ALIGN) * _ALIGN
    if not arrays:
        return None, (spec, [])
    shm = shared_memory.SharedMemory(create=True, size=max(total, 1))
    try:
        metas = []
        for a, off in zip(arrays, offsets):
            dst = np.ndarray(a.shape, a.dtype, buffer=shm.buf, offset=off)
            dst[...] = a
            metas.append((off, a.shape, a.dtype.str))
        return shm.name, (spec, metas)
    finally:
        shm.close()


def _rebuild(spec, arrays):
    if isinstance(spec, tuple) and len(spec) == 2 and spec[0] == "__arr__":
        return arrays[spec[1]]
    if isinstance(spec, tuple) and len(spec) == 2 and \
            spec[0] == "__tuple__":
        return tuple(_rebuild(s, arrays) for s in spec[1])
    if isinstance(spec, list):
        return [_rebuild(s, arrays) for s in spec]
    if isinstance(spec, dict):
        return {k: _rebuild(v, arrays) for k, v in spec.items()}
    return spec


def unpack(payload):
    """The batch of a ``pack`` payload; the block is copied out, then
    closed and unlinked."""
    name, (spec, metas) = payload
    if name is None:
        return _rebuild(spec, [])
    shm = shared_memory.SharedMemory(name=name)
    try:
        arrays = [np.ndarray(shape, np.dtype(dt), buffer=shm.buf,
                             offset=off).copy()
                  for off, shape, dt in metas]
    finally:
        shm.close()
        shm.unlink()
    return _rebuild(spec, arrays)


def run_worker(out_q, dataset, collate_fn, batches, wid, nw):
    """Produce batches wid, wid+nw, wid+2nw, ... as (seq, payload) on
    out_q, then ("__done__", wid); a failure is sent as ("__error__",
    traceback)."""
    try:
        for seq in range(wid, len(batches), nw):
            samples = [dataset[i] for i in batches[seq]]
            out_q.put((seq, pack(collate_fn(samples))))
    except BaseException as e:   # propagate worker failures to the parent
        try:
            out_q.put(("__error__", f"{type(e).__name__}: {e}\n"
                       + traceback.format_exc()), timeout=10.0)
        except Exception:
            pass
        return
    out_q.put(("__done__", wid))
