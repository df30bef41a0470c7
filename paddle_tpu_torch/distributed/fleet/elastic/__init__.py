"""Elastic training manager: the counterpart of
``paddle_tpu/distributed/fleet/elastic/__init__.py`` (ref:
fleet/elastic/manager.py:125 ElasticManager, :121 watch — heartbeats +
peer-change restart).

The heartbeat and rendezvous state lives in a store with ``get``/``set``
(``add`` for the resilient trainer's re-rendezvous): a
``torch.distributed.TCPStore`` on a cluster, or any object with that
surface (the tests use an in-memory one), or the port's ``TCPStore``
wrapper (``distributed.store``). A store whose ``get`` blocks
for a missing key (``TCPStore``) is asked ``check([key])`` first, so a
peer that never wrote a heartbeat reads as missing, as a ``KeyError`` from
the JAX package's store does.
"""

from __future__ import annotations

import os
import threading
import time


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


def _get(store, key):
    """store.get(key), a KeyError when the key is missing (asked through
    ``check`` where the store has it, since TCPStore's get blocks)."""
    check = getattr(store, "check", None)
    if check is not None and not check([key]):
        raise KeyError(key)
    return store.get(key)


class ElasticManager:
    def __init__(self, args=None, store=None, heartbeat_interval=5.0,
                 join_timeout=None):
        self._store = store
        self._interval = heartbeat_interval
        self._rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._stop = threading.Event()
        self._thread = None
        self.status = ElasticStatus.HOLD
        # clock-skew-free liveness: track the last LOCALLY-observed change of
        # each peer's heartbeat value, not the peer's own wall clock
        self._last_seen = {}     # rank -> (value, local_receipt_time)
        self._started_at = time.time()
        # guards the store swap + baseline reset (heartbeat thread)
        # against the watch() read path (caller thread): without it a
        # watch pass interleaved mid-reconnect can read the dead store or
        # a half-reset _last_seen/_started_at baseline and spuriously
        # return RESTART
        self._lock = threading.Lock()
        self._join_timeout = (join_timeout if join_timeout is not None
                              else 10 * heartbeat_interval)

    def _hb_key(self, rank):
        return f"heartbeat/{rank}"

    def _reconnect(self):
        """Fresh client to the same store endpoint. The master may be
        restarting in place (elastic_level=1 restarts the rank that hosts
        the TCPStore): a surviving rank's heartbeat must outlive the gap
        and resume against the new master, or the restarted watcher sees
        every survivor as dead (ref: manager.py etcd lease re-grant)."""
        host = getattr(self._store, "host", None)
        port = getattr(self._store, "port", None)
        if not host or not port:
            return None
        import datetime
        from torch.distributed import TCPStore

        from ...store import TCPStore as PortStore
        secs = max(1.0, min(3 * self._interval, 15.0))
        if isinstance(self._store, PortStore):
            fresh = PortStore(host, port, is_master=False, timeout=secs)
        else:
            fresh = TCPStore(host, port, is_master=False,
                             timeout=datetime.timedelta(seconds=secs))
        # rank 0's store object OWNS the in-process master server:
        # transfer it, or garbage-collecting the replaced client would
        # stop the rendezvous server for the whole cluster
        old = self._store
        if getattr(old, "_server", None) is not None:
            fresh._server = old._server
            old._server = None
        return fresh

    def start_heartbeat(self):
        if self._store is None:
            return

        def beat():
            while not self._stop.is_set():
                try:
                    self._store.set(self._hb_key(self._rank),
                                    str(time.time()))
                except Exception:
                    try:
                        fresh = self._reconnect()
                        if fresh is not None:
                            # a restarted master comes back EMPTY: reset
                            # the join baseline so watch() doesn't declare
                            # healthy-but-not-yet-rewritten peers dead,
                            # and beat immediately to close the gap. The
                            # swap + reset is atomic w.r.t. watch().
                            with self._lock:
                                self._store = fresh
                                self._last_seen.clear()
                                self._started_at = time.time()
                            self._store.set(self._hb_key(self._rank),
                                            str(time.time()))
                    except Exception:
                        pass   # master still down; retry next interval
                self._stop.wait(self._interval)
        self._thread = threading.Thread(target=beat, daemon=True)
        self._thread.start()

    def watch(self, timeout_factor=3.0):
        """One watch pass: a peer whose heartbeat value has not CHANGED
        (as observed locally — immune to cross-host clock skew) for
        timeout_factor*interval is failed; a peer that never wrote any
        heartbeat within join_timeout is failed too (startup crash).
        Returns ElasticStatus (ref: watch loop manager.py:121)."""
        if self._store is None:
            return ElasticStatus.HOLD
        # snapshot the (store, baseline) pair under the lock, then do the
        # per-peer network gets OUTSIDE it: holding the lock across
        # (world-1) blocking store timeouts would stall the heartbeat
        # thread's reconnect swap — the exact outage where recovery speed
        # matters. A swap mid-pass invalidates the snapshot; the pass
        # then returns HOLD instead of judging stale reads against the
        # fresh baseline.
        with self._lock:
            store = self._store
            started_at = self._started_at
        now = time.time()
        for r in range(self._world):
            if r == self._rank:
                continue
            try:
                val = _get(store, self._hb_key(r))
            except KeyError:
                # same swap guard as the success path below: a reconnect
                # mid-pass means this KeyError came from a just-restarted
                # (empty) master and the snapshotted started_at baseline
                # is stale — judging "never joined" against it would be
                # the exact spurious RESTART the lock exists to prevent
                with self._lock:
                    if self._store is not store:
                        self.status = ElasticStatus.HOLD
                        return self.status
                if now - started_at > self._join_timeout:
                    self.status = ElasticStatus.RESTART   # never joined
                    return self.status
                continue
            with self._lock:
                if self._store is not store:
                    self.status = ElasticStatus.HOLD  # reconnect mid-pass
                    return self.status
                prev = self._last_seen.get(r)
                if prev is None or prev[0] != val:
                    self._last_seen[r] = (val, now)
                    continue
                if now - prev[1] > timeout_factor * self._interval:
                    self.status = ElasticStatus.RESTART
                    return self.status
        self.status = ElasticStatus.HOLD
        return self.status

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)


__all__ = ["ElasticManager", "ElasticStatus"]
