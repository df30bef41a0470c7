"""Serving replicas — the unit the elastic fleet scales and loses.

A replica is one engine over one model copy. The router only ever talks
to a replica through the narrow ``ReplicaHandle`` surface:

- ``alive()``      — best-effort liveness (process/flag; heartbeats are
                     the router's second opinion),
- ``submit(snap, start)`` — run a serialized sequence snapshot
                     (``GenerationEngine.export_request`` schema) and
                     iterate ``(cursor, token)`` pairs from virtual
                     index ``start`` (exactly-once resume),
- ``kill()``       — abrupt death (tests/drills),
- and the KV-transfer plane (all optional — a router never
  NEEDS them, re-prefill stays the universal fallback):
  ``export_sequence(trace, kv)`` removes a resident sequence (found by
  its fleet trace id) and returns its snapshot with the computed KV
  pages riding along (the drain handoff), ``export_kv(tokens)`` reads
  the prefix-indexed pages covering a token chain (the prefill->decode
  handoff), ``import_kv(meta, payload)`` maps transferred pages in.
  On the subprocess wire the bulk page bytes travel as a binary
  SIDECAR FRAME after the newline-JSON header (length in the header),
  so the line protocol stays line-shaped and the pages ship once,
  unencoded.

Replicas may carry a ``role`` ("prefill" / "decode" / None): pure
metadata here — the ROUTER reads it to split compute-bound prefill
from bandwidth-bound decode across the fleet; an untagged replica
serves both exactly as before.

Two implementations:

- ``LocalReplica`` — engine + threads in THIS process. ``kill()``
  flips a dead flag the token pump checks between engine steps, so from
  the router's side the replica fails exactly like a SIGKILLed process
  (mid-stream ReplicaDeadError, no drain, state lost) while the test
  stays single-process and seconds-scale.
- ``ProcessReplica`` — a real subprocess (``paddle_tpu_torch.serving.worker``)
  speaking newline-JSON over a localhost socket; ``kill()`` is a real
  SIGKILL. The full fault drill runs on this one.

Replicas publish heartbeats to a store (TCPStore or serving.FileStore)
under ``serve/hb/<name>``: a monotonic seq plus the engine's occupancy /
page-pool / flight-recorder gauges — the health signals, now the
fleet's liveness payload. And each replica watches a checkpoint root's
committed LATEST pointer (``WeightWatcher``): a newly committed verified
checkpoint is swapped in BETWEEN engine steps without dropping in-flight
sequences — the continual-training→serving loop.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

import torch

from ..observability.metrics import REGISTRY as _REG
from ..observability.events import EVENTS as _EVENTS
from ..observability import flight_recorder as _flight
from ..observability import tracing as _tracing

__all__ = ["ReplicaDeadError", "LocalReplica", "ProcessReplica",
           "WeightWatcher", "HeartbeatPublisher", "HB_KEY_PREFIX"]

HB_KEY_PREFIX = "serve/hb/"

_C_SWAPS = _REG.counter("fleet_weight_swaps_total",
                        "hot weight swaps applied by replicas")
_H_SWAP = _REG.histogram("fleet_weight_swap_seconds",
                         "checkpoint load + prefix-index flush wall time")


class ReplicaDeadError(RuntimeError):
    """The replica died (or was killed) with this sequence in flight.
    The router reroutes the sequence; nothing is lost — the serialized
    state plus the router's delivery cursor reconstruct it on a peer."""


class WeightWatcher:
    """Watch a checkpoint root's committed LATEST pointer and hot-swap
    newer verified checkpoints into the model between engine steps.

    Consistency contract (the reason this is safe):

    - only a BARRIER-COMMITTED checkpoint is eligible
      (``checkpoint.find_latest_valid(committed_only=True)`` — the same
      rule restore() uses), so a replica can never serve a half-written
      or unverified step;
    - the swap runs under the engine's step lock
      (``GenerationEngine.swap_weights``): no compiled program is in
      flight with half-new params;
    - the prefix index is invalidated in the same critical section:
      cached KV computed under the old weights must never be mapped
      into a post-swap prefill;
    - in-flight sequences are NOT dropped — their pages stay, their
      continuation simply runs under the new weights (the standard
      serving hot-swap contract).
    """

    def __init__(self, model, ckpt_root, replica="r0", poll_interval=0.25):
        self._model = model
        self._root = ckpt_root
        self._replica = replica
        self._poll = float(poll_interval)
        self._last_check = 0.0
        self._lock = threading.Lock()
        self.loaded_step = -1
        self.swaps = 0

    def _load(self, path):
        from ..distributed import checkpoint as dck
        live = {f"model::{k}": t
                for k, t in self._model.state_dict(keep_vars=True).items()
                if isinstance(t, torch.Tensor)}
        # two-phase apply: read the WHOLE checkpoint into CPU staging
        # copies first, then copy them into the live tensors in place. A
        # failure mid-read (a file evicted between verify and load) leaves
        # the model wholly on the previous step, never a mix of two; and
        # the in-place copies keep every address the engine's captured
        # programs read
        staging = {k: t.detach().to("cpu", copy=True)
                   for k, t in live.items()}
        dck.load_state_dict(staging, path, verify=False)  # just verified
        with torch.no_grad():
            for k, t in live.items():
                t.copy_(staging[k])

    def maybe_swap(self, engine):
        """Rate-limited poll; swaps and returns the new step when a
        newer committed checkpoint landed, else None. Thread-safe, and
        non-blocking for losers of the race (the winner swaps)."""
        now = time.monotonic()
        if now - self._last_check < self._poll:
            return None
        if not self._lock.acquire(blocking=False):
            return None
        try:
            self._last_check = now
            from ..distributed import checkpoint as dck
            latest = dck.read_latest(self._root)
            if latest is None or latest[0] <= self.loaded_step:
                return None
            found = dck.find_latest_valid(self._root, committed_only=True)
            if found is None or found[0] <= self.loaded_step:
                return None
            step, path = found
            t0 = time.perf_counter()
            # the committed step names the weights for the prefix-store
            # consistency tag: replicas on the same step keep sharing
            # spilled KV pages across the swap
            engine.swap_weights(lambda: self._load(path),
                                tag=f"step{step}")
            _H_SWAP.observe(time.perf_counter() - t0)
            self.loaded_step = step
            self.swaps += 1
            _C_SWAPS.inc()
            _REG.gauge("fleet_replica_loaded_step",
                       "newest checkpoint step a replica has swapped in",
                       labels={"replica": self._replica}).set(step)
            _EVENTS.record("fleet_weight_swap", replica=self._replica,
                           step=step, path=path)
            return step
        except (OSError, ValueError) as e:   # torn read mid-commit: the
            _EVENTS.record("fleet_weight_swap_skipped",   # next poll wins
                           replica=self._replica, error=str(e)[:120])
            return None
        finally:
            self._lock.release()


class HeartbeatPublisher:
    """Background thread posting ``serve/hb/<name>`` to the store every
    interval: a monotonic seq (the router judges liveness by VALUE
    CHANGE, immune to clock skew — the ElasticManager rule) plus the
    engine health gauges. Store outages are absorbed: the beat retries
    next interval, and a router that sees no fresh value applies its
    own staleness policy."""

    def __init__(self, name, store, payload_fn, interval=0.2):
        self._key = HB_KEY_PREFIX + name
        self._store = store
        self._payload_fn = payload_fn
        self._interval = float(interval)
        self._stop = threading.Event()
        self._seq = 0
        self._thread = None

    def start(self):
        def beat():
            while not self._stop.is_set():
                self.beat_once()
                self._stop.wait(self._interval)
        self._thread = threading.Thread(target=beat, daemon=True,
                                        name=f"hb:{self._key}")
        self._thread.start()
        return self

    def beat_once(self):
        self._seq += 1
        payload = {"seq": self._seq, "ts": time.time()}
        try:
            payload.update(self._payload_fn() or {})
        except Exception:  # noqa: BLE001 — health payload is best-effort
            pass
        try:
            self._store.set(self._key, json.dumps(payload))
        except Exception:  # noqa: BLE001 — store outage: retry next beat
            pass

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)


# process incarnation token: OS pids are recycled, so a
# retired replica's final scrape keyed by bare pid could be shadowed
# (or double-skipped) by a LATER process that drew the same pid. The
# token is minted once per process import — (pid, inc) names an
# incarnation unambiguously for the router's scrape-retention logic.
_INCARNATION = os.urandom(4).hex()


def _metrics_payload(name):
    """The fleet metrics plane's per-process payload: full
    registry series (bucketed histograms included — snapshot() summaries
    cannot merge), quantile-sketch states (mergeable), and the event
    ring's drop count. One schema for LocalReplica (in-process) and the
    worker's ``metrics`` verb (over the socket), so the router's
    ``fleet_snapshot`` merges both kinds identically."""
    return {"name": name, "pid": os.getpid(), "inc": _INCARNATION,
            "series": _REG.collect(),
            "sketches": _tracing.export_states(),
            "events_dropped": _EVENTS.dropped}


def _engine_health(engine, watcher=None):
    """The occupancy/flight-recorder signals, per engine — the
    heartbeat payload the router reads as the replica's health."""
    active = sum(r is not None for r in engine._slots)
    out = {
        "active": active,
        "occupancy": active / max(engine.max_slots, 1),
        "waiting": len(engine._waiting),
        "free_pages": int(engine.blocks.free_pages),
        "pages_total": int(engine.blocks.n_pages - 1),
    }
    rec = _flight.get_recorder()
    if rec is not None:
        out["flight_last_seq"] = rec.last_committed_seq
    if watcher is not None:
        out["loaded_step"] = watcher.loaded_step
    return out


class LocalReplica:
    """In-process replica: engine + heartbeat + weight watcher."""

    def __init__(self, name, model, engine_kw=None, store=None,
                 ckpt_root=None, heartbeat_interval=0.2,
                 weight_poll_interval=0.25, engine=None, role=None):
        self.name = name
        self.model = model
        self.role = role
        model.eval()
        # an explicit engine bypasses the model's engine cache: a killed
        # replica abandons its engine mid-flight, and a later replica on
        # the same (model, pool shape) must not inherit that wreck
        self.engine = engine if engine is not None \
            else model.get_engine(**(engine_kw or {}))
        self._doctor = None        # lazy per-process Doctor
        self._dead = threading.Event()
        self.watcher = None
        if ckpt_root is not None:
            self.watcher = WeightWatcher(model, ckpt_root, replica=name,
                                         poll_interval=weight_poll_interval)
        self._hb = None
        if store is not None:
            self._hb = HeartbeatPublisher(
                name, store,
                lambda: dict(_engine_health(self.engine, self.watcher),
                             dead=self._dead.is_set(), role=self.role),
                interval=heartbeat_interval).start()

    # -- ReplicaHandle ----------------------------------------------------
    def alive(self):
        return not self._dead.is_set()

    def submit(self, snap, start=0):
        if not self.alive():
            raise ReplicaDeadError(f"replica {self.name} is dead")
        rid = self.engine.import_request(snap, streaming=True)
        # resolve the stream EAGERLY (stream_request pins the request
        # object now) — _pump is a generator, and a lazy lookup could
        # race a concurrent consumer's step that drains the request
        it = self.engine.stream_request(rid, int(start))
        return self._pump(it)

    def _pump(self, it):
        try:
            while True:
                if self._dead.is_set():
                    raise ReplicaDeadError(
                        f"replica {self.name} died mid-stream")
                if self.watcher is not None:
                    # between engine steps, by construction: we are
                    # between two next() calls of the stream
                    self.watcher.maybe_swap(self.engine)
                try:
                    cursor, tok = next(it)
                except StopIteration:
                    return
                if self._dead.is_set():
                    # the token was computed but "never sent": the peer
                    # regenerates it deterministically (greedy parity)
                    raise ReplicaDeadError(
                        f"replica {self.name} died mid-stream")
                yield cursor, tok
        finally:
            it.close()

    def metrics(self):
        """Fleet metrics plane: this process's registry/sketch payload.
        A dead replica refuses — its numbers would read as live."""
        if not self.alive():
            raise ReplicaDeadError(f"replica {self.name} is dead")
        return _metrics_payload(self.name)

    def ping(self):
        """Cheap liveness probe: proves the replica answers
        without paying a full registry collection — what the
        supervisor's quarantine probe sends every tick."""
        if not self.alive():
            raise ReplicaDeadError(f"replica {self.name} is dead")
        return {"ok": True, "name": self.name, "pid": os.getpid()}

    def doctor(self):
        """Per-replica doctor verdict: one streaming
        detector sweep over THIS process's registry/ring/sketches.
        The first call is the baseline window (always clean); each
        later call interprets what changed since the previous one.
        Returns the JSON-able ``Doctor.report()`` dict — the same
        schema the worker's ``doctor`` verb ships over the socket."""
        if not self.alive():
            raise ReplicaDeadError(f"replica {self.name} is dead")
        from ..observability.doctor import Doctor
        if self._doctor is None:
            self._doctor = Doctor(name=self.name)
        self._doctor.observe()
        return dict(self._doctor.report(), name=self.name,
                    pid=os.getpid())

    # -- KV transfer plane -------------------------------------
    def export_sequence(self, trace, kv=True):
        """Remove the resident sequence carrying fleet trace `trace`
        and return ``(snap, kv_meta, kv_payload)`` — the drain handoff:
        the sequence (undelivered tokens included) plus its computed KV
        pages leave this replica in one move. kv_meta/payload are None
        when nothing page-complete was computed (or kv=False)."""
        if not self.alive():
            raise ReplicaDeadError(f"replica {self.name} is dead")
        rid = self.engine.find_rid_by_trace(trace)
        snap = self.engine.remove_request(rid, with_kv=kv)
        kvd = snap.pop("kv", None)
        if kvd is None:
            return snap, None, None
        return snap, kvd["meta"], kvd["payload"]

    def export_kv(self, tokens, trace=None):
        """Serialize the prefix-indexed KV pages covering `tokens`
        (``(meta, payload)`` or ``(None, None)``) — what a prefill
        replica hands the decode replica."""
        if not self.alive():
            raise ReplicaDeadError(f"replica {self.name} is dead")
        got = self.engine.export_kv_pages(tokens, trace=trace)
        if got is None:
            return None, None
        return got

    def import_kv(self, meta, payload, trace=None):
        """Map a transferred page batch into this replica's engine;
        returns pages newly mapped."""
        if not self.alive():
            raise ReplicaDeadError(f"replica {self.name} is dead")
        return self.engine.import_kv_pages(meta, payload, trace=trace)

    def cancel(self, trace, reason=None):
        """Cancellation propagation: tear down the live
        request carrying fleet trace `trace` within one engine step —
        slot and pages freed now, not at token budget. Idempotent:
        False when nothing live carries the trace (already finished,
        already cancelled, never placed here). `reason` tags the cost
        ledger's waste bucket (hedge_loser / abandoned)."""
        if not self.alive():
            raise ReplicaDeadError(f"replica {self.name} is dead")
        return bool(self.engine.cancel_by_trace(trace, reason=reason))

    def poll(self):
        """Idle-path maintenance tick (router health loop): weight swap
        checks must not depend on traffic flowing."""
        if self.watcher is not None and self.alive():
            self.watcher.maybe_swap(self.engine)

    def kill(self):
        """Abrupt death: every in-flight pump raises ReplicaDeadError at
        its next step boundary; no drain, no state handoff — the
        router's journal is the only survivor, as with a real SIGKILL.
        Heartbeats stop too (a SIGKILLed process cannot beat)."""
        self._dead.set()
        if self._hb is not None:
            self._hb.stop()

    def shutdown(self):
        self._dead.set()
        if self._hb is not None:
            self._hb.stop()


class ProcessReplica:
    """Parent-side handle of a subprocess replica worker.

    The worker (``python -m paddle_tpu_torch.serving.worker``) owns the model
    + engine, serves sequence streams over a localhost socket (one
    newline-JSON request per connection), heartbeats through a
    ``FileStore`` root, and watches ``--ckpt-root`` for weight swaps.
    ``kill()`` is a genuine SIGKILL — the drill's fault."""

    def __init__(self, name, spec, store_root=None, ckpt_root=None,
                 heartbeat_interval=0.2, startup_timeout=180.0, env=None,
                 connect_timeout=10.0, read_timeout=300.0,
                 events_path=None, metrics_port=None, slo_targets=None,
                 role=None, kv_store_root=None):
        """connect_timeout bounds reaching the worker at all;
        read_timeout bounds ONE token gap — it must cover a cold
        compile (the first sequence on a fresh worker traces its
        programs mid-stream), so it is deliberately generous. A
        SIGKILLed worker is detected by EOF/RST immediately, not by
        this timeout. events_path turns on the worker's durable JSONL
        event sink (written per record, so a SIGKILLed worker's spans
        survive to be merged by tools/trace_report.py); metrics_port
        exposes a stdlib HTTP /metrics scrape endpoint in the worker;
        slo_targets ({'ttft_ms': 250, ...}) arms the worker-process SLO
        budgets so its engine-side (per-tenant) attainment gauges grade
        against the fleet's targets. role tags the worker
        for role-split routing; kv_store_root points the
        worker's engine at a FileStore-backed fleet prefix store
        (evicted prefix pages spill there, admissions refill from it —
        cross-process prefix hits)."""
        self.name = name
        self.role = role
        self.port = None
        self._connect_timeout = float(connect_timeout)
        self._read_timeout = float(read_timeout)
        repo = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        cmd = [sys.executable, "-m", "paddle_tpu_torch.serving.worker",
               "--name", name, "--spec", json.dumps(spec),
               "--heartbeat-interval", str(heartbeat_interval)]
        if store_root:
            cmd += ["--store-root", store_root]
        if ckpt_root:
            cmd += ["--ckpt-root", ckpt_root]
        if events_path:
            cmd += ["--events-jsonl", events_path]
        if metrics_port is not None:
            cmd += ["--metrics-port", str(metrics_port)]
        if slo_targets:
            cmd += ["--slo-targets", json.dumps(slo_targets)]
        if role:
            cmd += ["--role", str(role)]
        if kv_store_root:
            cmd += ["--kv-store-root", kv_store_root]
        env = dict(os.environ, **(env or {}))
        self.proc = subprocess.Popen(
            cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, errors="replace")
        # the READY wait must enforce its deadline even when the worker
        # produces NO output (wedged CUDA init, hung model build):
        # readline() on the pipe would block past any deadline check, so
        # a reader thread feeds a queue and the main thread waits with
        # the remaining budget — the serve analog of the
        # bounded-native-startup fix. The same thread then keeps
        # draining stdout so a chatty worker never blocks on a full
        # pipe (its tokens flow over the socket, not stdout).
        import queue
        lines_q = queue.Queue(maxsize=1000)

        def reader(pipe):
            try:
                for ln in pipe:
                    try:
                        lines_q.put_nowait(ln)
                    except queue.Full:
                        pass     # post-READY chatter: drop, keep draining
            except (OSError, ValueError):
                pass
            try:
                lines_q.put_nowait(None)         # EOF marker
            except queue.Full:
                pass
        threading.Thread(target=reader, args=(self.proc.stdout,),
                         daemon=True).start()
        deadline = time.monotonic() + startup_timeout
        lines = []
        while True:
            try:
                line = lines_q.get(
                    timeout=max(0.05, deadline - time.monotonic()))
            except queue.Empty:
                if time.monotonic() <= deadline:
                    continue
                self.proc.kill()
                raise TimeoutError(
                    f"replica worker {name} not ready within "
                    f"{startup_timeout}s (no READY line); output tail:\n"
                    + "".join(lines[-20:])) from None
            if line is None:
                raise RuntimeError(
                    f"replica worker {name} exited rc={self.proc.poll()} "
                    "before READY; output tail:\n" + "".join(lines[-20:]))
            lines.append(line)
            if line.startswith("SERVE_WORKER_READY"):
                self.port = int(line.split("port=")[1].split()[0])
                break

    # -- ReplicaHandle ----------------------------------------------------
    def alive(self):
        return self.proc.poll() is None

    def submit(self, snap, start=0):
        import socket
        if not self.alive():
            raise ReplicaDeadError(
                f"replica {self.name} process exited rc={self.proc.poll()}")
        try:
            sock = socket.create_connection(("127.0.0.1", self.port),
                                            timeout=self._connect_timeout)
        except OSError as e:
            raise ReplicaDeadError(
                f"replica {self.name} unreachable: {e}") from e
        sock.settimeout(self._read_timeout)
        return self._pump(sock, snap, int(start))

    def _pump(self, sock, snap, start):
        try:
            f = sock.makefile("rwb")
            f.write(json.dumps({"snap": snap, "start": start})
                    .encode() + b"\n")
            f.flush()
            while True:
                try:
                    line = f.readline()
                except OSError as e:            # RST from a SIGKILL
                    raise ReplicaDeadError(
                        f"replica {self.name} connection lost: {e}") from e
                if not line:
                    raise ReplicaDeadError(
                        f"replica {self.name} closed the stream "
                        "before done (killed?)")
                try:
                    msg = json.loads(line)
                except ValueError as e:
                    # a SIGKILL mid-write flushes a TRUNCATED line before
                    # FIN; a live worker never writes malformed JSON —
                    # this is a death, and must reroute, not fail the
                    # request
                    raise ReplicaDeadError(
                        f"replica {self.name} stream truncated "
                        f"mid-line (killed?): {line[:60]!r}") from e
                if msg.get("done"):
                    return
                if "error" in msg:
                    err = str(msg["error"])
                    # preserve the exception class across the wire (the
                    # _kv_rpc KeyError rule): a deadline expiry or a
                    # cancel is an ACCOUNTED outcome the router must not
                    # misread as an infrastructure failure
                    if err.startswith("DeadlineExceededError"):
                        from ..inference.engine import DeadlineExceededError
                        raise DeadlineExceededError(
                            f"replica {self.name}: {err}")
                    if err.startswith("RequestCancelledError"):
                        from ..inference.engine import RequestCancelledError
                        raise RequestCancelledError(
                            f"replica {self.name}: {err}")
                    raise RuntimeError(
                        f"replica {self.name} rejected the sequence: "
                        f"{err}")
                yield int(msg["cursor"]), int(msg["token"])
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _oneline_verb(self, verb, **extra):
        """One line-JSON verb round trip on the worker socket (the
        ``metrics``/``doctor`` scrape shape: one request line, one
        response line, no sidecar frames). Short read timeout — these
        verbs are host-side dict assembly, never a compile."""
        import socket
        if not self.alive():
            raise ReplicaDeadError(
                f"replica {self.name} process exited rc={self.proc.poll()}")
        sock = socket.create_connection(("127.0.0.1", self.port),
                                        timeout=self._connect_timeout)
        try:
            sock.settimeout(self._connect_timeout)
            f = sock.makefile("rwb")
            f.write(json.dumps({"verb": verb, **extra}).encode() + b"\n")
            f.flush()
            line = f.readline()
            if not line:
                raise ReplicaDeadError(
                    f"replica {self.name} closed the {verb} stream")
            payload = json.loads(line)
            if "error" in payload:      # worker-side failure, structured
                raise RuntimeError(
                    f"replica {self.name} {verb} verb failed: "
                    f"{payload['error']}")
            return payload
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def metrics(self):
        """Fleet metrics plane: one ``metrics``-verb round trip on the
        worker socket."""
        return self._oneline_verb("metrics")

    def doctor(self):
        """Per-replica doctor verdict: one ``doctor``-verb
        round trip — the worker runs a detector sweep over ITS OWN
        registry and answers with the ``Doctor.report()`` schema. The
        first call baselines (always clean); later calls interpret the
        window since the previous one."""
        return self._oneline_verb("doctor")

    def ping(self):
        """Cheap liveness probe: one ``ping``-verb round
        trip — the worker answers without collecting its registry, so
        a quarantined replica can be probed every supervisor tick."""
        return self._oneline_verb("ping")

    def cancel(self, trace, reason=None):
        """See LocalReplica.cancel — the subprocess form (one
        ``cancel``-verb round trip; `reason` rides the verb so the
        worker's ledger books the right waste bucket)."""
        resp = self._oneline_verb("cancel", trace=trace, reason=reason)
        return bool(resp.get("cancelled"))

    # -- KV transfer plane -------------------------------------
    def _kv_rpc(self, header, payload=None):
        """One round trip on the worker socket with optional binary
        SIDECAR frames both ways: the newline-JSON header states the
        frame length (``nbytes`` out, ``kv_nbytes`` back), the raw page
        bytes follow unencoded — the line protocol stays line-shaped
        and the bulk moves once. Returns (response_dict, sidecar_bytes
        or None)."""
        import socket
        if not self.alive():
            raise ReplicaDeadError(
                f"replica {self.name} process exited rc={self.proc.poll()}")
        sock = socket.create_connection(("127.0.0.1", self.port),
                                        timeout=self._connect_timeout)
        try:
            sock.settimeout(self._read_timeout)
            f = sock.makefile("rwb")
            f.write(json.dumps(header).encode() + b"\n")
            if payload:
                f.write(payload)
            f.flush()
            line = f.readline()
            if not line:
                raise ReplicaDeadError(
                    f"replica {self.name} closed the transfer stream "
                    "(killed?)")
            try:
                resp = json.loads(line)
            except ValueError as e:
                raise ReplicaDeadError(
                    f"replica {self.name} transfer header truncated "
                    f"(killed?): {line[:60]!r}") from e
            if "error" in resp:
                if str(resp["error"]).startswith("KeyError"):
                    # preserve the exception class across the wire: a
                    # not-resident rid is a benign race the router
                    # classifies differently from a broken transfer
                    raise KeyError(
                        f"replica {self.name}: {resp['error']}")
                raise RuntimeError(
                    f"replica {self.name} refused {header.get('verb')}: "
                    f"{resp['error']}")
            n = int(resp.get("kv_nbytes") or 0)
            sidecar = None
            if n:
                sidecar = f.read(n)
                if sidecar is None or len(sidecar) != n:
                    raise ReplicaDeadError(
                        f"replica {self.name} sidecar frame truncated "
                        f"({0 if sidecar is None else len(sidecar)}"
                        f"/{n} bytes — killed mid-transfer?)")
            return resp, sidecar
        except (OSError, socket.timeout) as e:
            raise ReplicaDeadError(
                f"replica {self.name} transfer connection lost: "
                f"{e}") from e
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def export_sequence(self, trace, kv=True):
        """See LocalReplica.export_sequence — the subprocess form."""
        resp, sidecar = self._kv_rpc(
            {"verb": "export", "trace": trace, "kv": bool(kv)})
        return resp["snap"], resp.get("kv_meta"), sidecar

    def export_kv(self, tokens, trace=None):
        """See LocalReplica.export_kv — the subprocess form."""
        resp, sidecar = self._kv_rpc(
            {"verb": "export_kv", "tokens": [int(t) for t in tokens],
             "trace": trace})
        return resp.get("kv_meta"), sidecar

    def import_kv(self, meta, payload, trace=None):
        """See LocalReplica.import_kv — the subprocess form."""
        resp, _ = self._kv_rpc(
            {"verb": "import_kv", "meta": meta, "trace": trace,
             "nbytes": len(payload)}, payload=payload)
        return int(resp.get("pages", 0))

    def kill(self):
        if self.alive():
            os.kill(self.proc.pid, signal.SIGKILL)
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass

    def poll(self):
        pass            # the worker runs its own weight-watcher ticks

    def shutdown(self):
        if self.alive():
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
