"""Collective hang detection: the counterpart of
``paddle_tpu/distributed/watchdog.py`` (ref: the comm watchdog the
reference runs as a background thread — phi/core/distributed/
comm_task_manager.h:37, nccl_comm_task.h:53 IsTimeout).

A collective or a transfer hangs when a peer dies or the interconnect
wedges: the wait for its result blocks forever with no diagnostics.
``watched_wait`` runs the blocking wait on a worker thread and raises
``CommTimeoutError`` with an actionable message when the deadline passes.
The wait (``_block``, the seam tests monkeypatch as the JAX tests patch
``jax.block_until_ready``) takes a tensor (its stream is synchronized: on
the card, everything queued before it has run), a ``torch.cuda.Event``, a
``torch.distributed`` work handle (``wait()``), or a nest of them.

Enable globally with ``framework.set_flags({"FLAGS_comm_timeout_s":
60})``: ``timeout=None`` reads it, and 0 blocks without a deadline.
A timeout dumps the collective flight recorder (when one is active) and
mirrors a ``comm_timeout`` event, as in the JAX package.
"""

from __future__ import annotations

import threading

from ..framework.flags import get_flag
from ..observability import flight_recorder as _flight


class CommTimeoutError(RuntimeError):
    """A collective/transfer did not complete within the deadline.

    Carries `what` (the operation label) and `timeout` (seconds) so the
    recovery layer (distributed.resilient) can log/route without parsing
    the message."""

    def __init__(self, msg, what="collective", timeout=None):
        super().__init__(msg)
        self.what = what
        self.timeout = timeout


def _block(value):
    """Block until `value` is ready: a CUDA tensor's stream synchronized,
    an event or a work handle waited for, a nest of them each in turn (a
    CPU tensor is ready already)."""
    import torch
    if isinstance(value, (list, tuple)):
        for v in value:
            _block(v)
    elif isinstance(value, dict):
        for v in value.values():
            _block(v)
    elif isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            torch.cuda.current_stream(value.device).synchronize()
    elif hasattr(value, "synchronize"):     # torch.cuda.Event, Stream
        value.synchronize()
    elif hasattr(value, "wait"):            # torch.distributed Work
        value.wait()
    return value


def watched_wait(value, timeout=None, what="collective", on_timeout=None):
    """``_block(value)`` with a deadline.

    timeout=None reads FLAGS_comm_timeout_s (0 disables the watchdog and
    blocks indefinitely, the reference default). Raises CommTimeoutError on
    expiry; the blocked thread is left behind (the wait itself is not
    interruptible — same as a hung NCCL kernel), but the caller regains
    control to trigger elastic restart / diagnostics.
    """
    if timeout is None:
        timeout = float(get_flag("FLAGS_comm_timeout_s") or 0.0)
    if not timeout or timeout <= 0:
        _block(value)
        return value

    done = threading.Event()
    err = []

    def _wait():
        try:
            _block(value)
        except Exception as e:   # surfaced after join
            err.append(e)
        finally:
            done.set()

    # the blocking wait is itself a flight-ring entry: on a timeout the
    # uncommitted `wait:<what>` is the in-flight op named in the dump.
    # active() honors the single-flag telemetry disable.
    _rec = _flight.RECORDER[0] if _flight.active() else None
    _seq = _rec.begin(f"wait:{what}") if _rec is not None else None

    t = threading.Thread(target=_wait, daemon=True)
    t.start()
    if not done.wait(timeout):
        # NOTE: must not rebind `err` — the _wait daemon thread still
        # appends to that list if the wedged wait eventually fails
        timeout_err = CommTimeoutError(
            f"{what} did not complete within {timeout:.1f}s. Likely causes: "
            f"a peer process died mid-collective, collectives were issued "
            f"in different orders across ranks, or the device interconnect "
            f"is wedged. Actions: check peer liveness (elastic heartbeats), "
            f"restart the worker (ResilientTrainer recover='exit' under an "
            f"elastic launcher), or probe the device in a subprocess before "
            f"retrying.", what=what, timeout=timeout)
        # default diagnostics: dump the collective flight ring (when a
        # recorder is active) and mirror a comm_timeout event carrying the
        # last-matched seq. Runs BEFORE the user hook so a raising hook
        # can't lose the dump.
        try:
            _flight.dump_on_timeout(what=what, timeout=timeout)
        except Exception:         # diagnostics must not mask the timeout
            pass
        if on_timeout is not None:
            try:
                on_timeout(timeout_err)   # recovery hook (resilient) —
            except Exception:     # diagnostics must not mask the timeout
                pass
        raise timeout_err
    if err:
        raise err[0]
    if _seq is not None:
        _rec.commit(_seq)
    return value


class watch:
    """Context manager timing a communication region:

        with watchdog.watch("allreduce step 12", timeout=60):
            loss = step(batch)      # anything that may hang

    On exit the produced values are NOT waited on — pair with watched_wait
    for that; this guards python-side deadlocks (e.g. a rendezvous that
    never returns) via a background timer that fires a diagnostic.
    """

    def __init__(self, what="comm", timeout=None, on_timeout=None):
        self.what = what
        self.timeout = timeout
        self.on_timeout = on_timeout
        self._timer = None

    def __enter__(self):
        timeout = self.timeout
        if timeout is None:
            timeout = float(get_flag("FLAGS_comm_timeout_s") or 0.0)
        if timeout and timeout > 0:
            def fire():
                msg = (f"[watchdog] {self.what} still running after "
                       f"{timeout:.1f}s — possible hang")
                if self.on_timeout is not None:
                    self.on_timeout(msg)
                else:
                    import sys
                    print(msg, file=sys.stderr, flush=True)
            self._timer = threading.Timer(timeout, fire)
            self._timer.daemon = True
            self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.cancel()
        return False


__all__ = ["CommTimeoutError", "watched_wait", "watch"]
