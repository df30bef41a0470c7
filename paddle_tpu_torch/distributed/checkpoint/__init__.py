"""Checkpoints: the counterpart of
``paddle_tpu/distributed/checkpoint/__init__.py`` for one process —
``save_state_dict`` (:152), ``load_state_dict`` (:282),
``verify_checkpoint``, the step directories with their ``LATEST`` pointer
and retention (``save_checkpoint`` :496 with ``async_save``,
``list_checkpoints``, ``read_latest``, ``find_latest_valid`` :567,
``load_latest`` :606).

The files are the JAX package's, byte for byte in layout, so a checkpoint
written by one package loads into the other: ``path/metadata.json``
({key: {"global_shape", "dtype", "stored_as", "shards": [{"offsets",
"lengths", "file", "crc32"}]}}, or {"py": true, "value": v} for a
Python scalar) and one ``<key>__<i>.npy`` per shard, bfloat16 stored as
its uint16 bits (``"stored_as": "bfloat16-as-uint16"``); every file lands
through a temporary name and an atomic rename, ``metadata.json`` last, and
``LATEST`` ({"step", "dir"}) is replaced atomically after it. A process
holds whole tensors, so it writes one shard a tensor (``__0``) and loads
any saved sharding by assembling the target box from the overlapping
shards. Temporary names carry the process id, so processes that save the
same files into one directory (ranks of a world saving what they hold
alike) never rename another's half-written file.

``save_checkpoint(world_size=n)`` commits through the multi-host barrier
(:496-560): each rank posts ``root/.progress.<rank>`` ("<lineage>:<step>",
the JAX package's bytes) once its files are durable, and the coordinator
moves LATEST only when every rank has posted this lineage at this step
or later, raising ``TimeoutError`` (LATEST left where it was) after
`barrier_timeout` seconds. Not ported: the orbax variants (:619-641:
orbax imports JAX) and the telemetry counters.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import sys
import threading
import time
import zlib

import numpy as np
import torch


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory failed verification (a missing or truncated
    shard file, a checksum mismatch, or an unreadable metadata.json)."""


# one async save in flight at a time; a new save or a load waits for the
# previous one
_async_lock = threading.Lock()
_async_pending = []


class AsyncSaveHandle:
    """Returned by ``save_state_dict(async_save=True)``: the host copies
    are taken before it returns (training may change the tensors at
    once); only the file writes run on a background thread."""

    def __init__(self, thread):
        self._thread = thread
        self._exc = None

    def done(self):
        return not self._thread.is_alive()

    def result(self, timeout=None):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("async checkpoint save still running")
        if self._exc is not None:
            raise self._exc


def wait_async_save():
    """Wait for every pending async save (raising the first failure)."""
    with _async_lock:
        pending, _async_pending[:] = _async_pending[:], []
    for h in pending:
        h.result()


def _drain_async_at_exit():
    """Finish in-flight saves before the interpreter exits; a failed one
    is reported on stderr, never raised at exit."""
    with _async_lock:
        pending, _async_pending[:] = _async_pending[:], []
    for h in pending:
        try:
            h.result()
        except Exception as e:  # noqa: BLE001 -- reported, exit goes on
            print(f"[paddle_tpu_torch.checkpoint] async checkpoint save "
                  f"failed during interpreter exit: {type(e).__name__}: "
                  f"{e}", file=sys.stderr, flush=True)


atexit.register(_drain_async_at_exit)


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _to_storable(t):
    """A tensor -> (numpy array of its bytes' values, stored_as tag): a
    host copy, bfloat16 as its uint16 bits."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), \
            "bfloat16-as-uint16"
    return t.numpy(), None


def _to_tensor(arr, stored_as):
    """A stored numpy array -> a CPU tensor of the saved type."""
    arr = np.array(arr, copy=True, order="C")       # 0-dim stays 0-dim
    if stored_as == "bfloat16-as-uint16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _crc32_of(arr):
    """crc32 of an array's data bytes (not the .npy container, so the same
    value verifies a memory-mapped load)."""
    arr = np.ascontiguousarray(arr)
    try:
        return zlib.crc32(memoryview(arr).cast("B")) & 0xFFFFFFFF
    except (TypeError, ValueError):
        return zlib.crc32(arr.tobytes()) & 0xFFFFFFFF


def _safe(key):
    return key.replace("/", "_").replace("\\", "_")


def save_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, async_save=False,
                    _on_complete=None):
    """Write {key: tensor or Python scalar} to `path` (metadata.json and
    one ``<key>__0.npy`` a tensor). With async_save the host copies are
    taken now and the writes run on a background thread; returns an
    ``AsyncSaveHandle`` (else None). A save first waits for the pending
    ones, so files never interleave."""
    wait_async_save()
    os.makedirs(path, exist_ok=True)
    meta = {}
    writes = []
    for key, t in state_dict.items():
        if not isinstance(t, torch.Tensor):
            if not isinstance(t, (int, float, str, bool, type(None))):
                raise TypeError(
                    f"state_dict entry '{key}' has non-checkpointable type "
                    f"{type(t).__name__}; save tensors or primitives")
            meta[key] = {"py": True, "value": t}
            continue
        shape = [int(s) for s in t.shape]
        data, stored_as = _to_storable(t)
        fname = f"{_safe(key)}__0.npy"
        rec = {"offsets": [0] * len(shape), "lengths": shape,
               "file": fname}
        writes.append((fname, data, rec))
        meta[key] = {"global_shape": shape, "dtype": _dtype_name(t),
                     "shards": [rec], "stored_as": stored_as}

    def _write():
        for fname, data, rec in writes:
            rec["crc32"] = _crc32_of(data)
            tmp = os.path.join(path, f"{fname}.{os.getpid()}.tmp")
            with open(tmp, "wb") as f:
                np.save(f, data)
            os.replace(tmp, os.path.join(path, fname))
        tmp = os.path.join(path, f"metadata.json.{os.getpid()}.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, os.path.join(path, "metadata.json"))
        if _on_complete is not None:
            _on_complete()

    if not async_save:
        _write()
        return None
    box = {}

    def _run():
        try:
            _write()
        except Exception as e:  # noqa: BLE001 -- raised by result()
            box["h"]._exc = e

    thread = threading.Thread(target=_run, name="ckpt-async-save",
                              daemon=True)
    handle = box["h"] = AsyncSaveHandle(thread)
    with _async_lock:
        _async_pending.append(handle)
    thread.start()
    return handle


def _assemble(path, entry):
    """The whole saved tensor, as a numpy array in the stored type,
    assembled from its shard files (each copied into its box)."""
    shape = entry["global_shape"]
    first = np.load(os.path.join(path, entry["shards"][0]["file"]),
                    mmap_mode="r")
    buf = np.empty(shape, dtype=first.dtype)
    filled = 0
    for sh in entry["shards"]:
        src = np.load(os.path.join(path, sh["file"]), mmap_mode="r")
        box = tuple(slice(o, o + n) for o, n in
                    zip(sh["offsets"], sh["lengths"]))
        buf[box] = src
        filled += int(np.prod(sh["lengths"]))
    if filled < int(np.prod(shape)):
        raise ValueError("checkpoint shards do not cover the tensor")
    return buf


@torch.no_grad()
def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, verify=True):
    """Fill the tensors of `state_dict` in place from the checkpoint at
    `path` (each cast to its target's type, on its target's device; a
    saved Python scalar replaces its entry). With verify every shard file
    is checked against its crc32 first (``CheckpointCorruptError``).
    Returns the keys the checkpoint does not hold."""
    wait_async_save()
    if verify:
        ok, reason = verify_checkpoint(path)
        if not ok:
            raise CheckpointCorruptError(
                f"checkpoint at {path} failed verification: {reason}")
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    missing = []
    for key, t in list(state_dict.items()):
        if key not in meta:
            missing.append(key)
            continue
        entry = meta[key]
        if entry.get("py"):
            state_dict[key] = entry["value"]
            continue
        if not isinstance(t, torch.Tensor):
            continue
        shape = tuple(entry["global_shape"])
        if tuple(t.shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {shape} != target "
                             f"{tuple(t.shape)}")
        full = _to_tensor(_assemble(path, entry), entry.get("stored_as"))
        t.copy_(full.to(t.dtype))
    return missing


_STEP_PREFIX = "step_"
LATEST_FILE = "LATEST"


def checkpoint_dir(root, step):
    return os.path.join(root, f"{_STEP_PREFIX}{int(step):08d}")


def _parse_step(name):
    if not name.startswith(_STEP_PREFIX):
        return None
    try:
        return int(name[len(_STEP_PREFIX):])
    except ValueError:
        return None


def list_checkpoints(root):
    """[(step, path)] of the step directories under root, by step."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        step = _parse_step(name)
        p = os.path.join(root, name)
        if step is not None and os.path.isdir(p):
            out.append((step, p))
    out.sort()
    return out


def verify_checkpoint(path):
    """(ok, reason) for one checkpoint directory, without loading it:
    metadata.json readable, every shard file present and loadable (a
    truncated file cannot be mapped), and each shard's data crc32 equal
    to the recorded one."""
    try:
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"metadata.json unreadable: {e}"
    for entry in meta.values():
        if entry.get("py"):
            continue
        for sh in entry.get("shards", []):
            try:
                arr = np.load(os.path.join(path, sh["file"]), mmap_mode="r")
            except (OSError, ValueError, EOFError) as e:
                return False, f"{sh['file']}: unreadable/truncated ({e})"
            want = sh.get("crc32")
            if want is not None:
                try:
                    got = _crc32_of(arr)
                except (OSError, ValueError) as e:
                    return False, f"{sh['file']}: read failed ({e})"
                if got != want:
                    return False, (f"{sh['file']}: crc32 mismatch "
                                   f"(stored {want}, computed {got})")
    return True, ""


def _commit_latest(root, step):
    """Point root/LATEST at step's directory (a temporary file and an
    atomic replace: a crash leaves the previous pointer or the new one)."""
    tmp = os.path.join(root, LATEST_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"step": int(step),
                   "dir": os.path.basename(checkpoint_dir(root, step))}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(root, LATEST_FILE))


def read_latest(root):
    """(step, path) that LATEST names, or None."""
    try:
        with open(os.path.join(root, LATEST_FILE)) as f:
            rec = json.load(f)
        return int(rec["step"]), os.path.join(root, rec["dir"])
    except (OSError, ValueError, KeyError, TypeError):
        return None


def _gc_old_checkpoints(root, keep_last_n):
    """Remove all but the newest keep_last_n step directories (never the
    one LATEST names)."""
    if not keep_last_n or keep_last_n <= 0:
        return
    latest = read_latest(root)
    protect = {os.path.abspath(latest[1])} if latest else set()
    for _, p in list_checkpoints(root)[:-keep_last_n]:
        if os.path.abspath(p) not in protect:
            shutil.rmtree(p, ignore_errors=True)


def post_progress(root, rank, tag, step):
    """Publish a rank's durable save progress atomically
    (root/.progress.<rank> = "<tag>:<step>") for the commit barrier."""
    tmp = os.path.join(root, f".progress.{int(rank)}.tmp")
    with open(tmp, "w") as f:
        f.write(f"{tag}:{int(step)}")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(root, f".progress.{int(rank)}"))


def read_progress(root, rank):
    """(tag, step) a rank last posted, or None."""
    try:
        with open(os.path.join(root, f".progress.{int(rank)}")) as f:
            val = f.read().strip()
        tag, _, s = val.rpartition(":")
        return (tag, int(s)) if tag else None
    except (OSError, ValueError):
        return None


def _await_progress(root, step, tag, world_size, timeout):
    """The coordinator's wait: every rank's posted progress in lineage
    `tag` at `step` or later (a peer ahead satisfies it; a post of another
    lineage, an aborted attempt's, never does)."""
    deadline = time.monotonic() + timeout
    while True:
        if all((p := read_progress(root, r)) is not None and p[0] == tag
               and p[1] >= int(step) for r in range(world_size)):
            return
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"checkpoint commit barrier for step {step} (lineage "
                f"{tag}) timed out after {timeout}s: a peer died mid-save "
                "or is in another lineage; LATEST stays at the previous "
                "checkpoint")
        time.sleep(0.05)


def save_checkpoint(state_dict, root, step, *, async_save=False,
                    keep_last_n=None, store=None, world_size=1, rank=0,
                    coordinator_rank=0, barrier_timeout=120.0,
                    barrier_tag=""):
    """``save_state_dict`` into root/step_<N>/, then the commit (with
    async_save, on the writer thread after the files have landed): with
    world_size above 1 this rank posts its progress and the coordinator
    waits at the barrier for every rank (see the module docstring); then
    the coordinator moves LATEST to the step and removes the step
    directories past keep_last_n. `store` is unused by the barrier (the
    files live in the shared root), as in the JAX package."""
    os.makedirs(root, exist_ok=True)

    def _commit():
        if world_size > 1:
            tag = barrier_tag or "-"
            post_progress(root, rank, tag, step)
            if rank == coordinator_rank:
                _await_progress(root, step, tag, world_size,
                                barrier_timeout)
        if rank == coordinator_rank:
            _commit_latest(root, step)
            _gc_old_checkpoints(root, keep_last_n)

    return save_state_dict(state_dict, checkpoint_dir(root, step),
                           async_save=async_save, _on_complete=_commit)


def find_latest_valid(root, committed_only=False):
    """(step, path) of the newest step directory under root that passes
    ``verify_checkpoint`` (one mid-write, truncated or corrupt is skipped
    for the one before it), or None. committed_only also requires step <=
    LATEST's step (None when there is no LATEST)."""
    ceiling = None
    if committed_only:
        latest = read_latest(root)
        if latest is None:
            return None
        ceiling = latest[0]
    for step, p in reversed(list_checkpoints(root)):
        if ceiling is not None and step > ceiling:
            continue
        if verify_checkpoint(p)[0]:
            return step, p
    return None


def load_latest(state_dict, root, committed_only=False):
    """Load `state_dict` from the newest valid checkpoint under root;
    returns its (step, path), or None when there is none."""
    found = find_latest_valid(root, committed_only=committed_only)
    if found is None:
        return None
    load_state_dict(state_dict, found[1], verify=False)
    return found


__all__ = ["AsyncSaveHandle", "CheckpointCorruptError", "LATEST_FILE",
           "checkpoint_dir", "find_latest_valid", "list_checkpoints",
           "load_latest", "load_state_dict", "post_progress",
           "read_latest", "read_progress", "save_checkpoint",
           "save_state_dict", "verify_checkpoint", "wait_async_save"]
