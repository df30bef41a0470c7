"""Subprocess replica worker — the process the fault drill SIGKILLs.

Owns one model + engine; serves sequence snapshots over a localhost
socket (one newline-JSON request per connection, streamed
``{"cursor": i, "token": t}`` lines, final ``{"done": true}``),
heartbeats through a ``serving.FileStore`` root, and watches a
checkpoint root for committed-LATEST weight swaps. Spawned and driven
by ``serving.replica.ProcessReplica``; runnable standalone:

    python -m paddle_tpu_torch.serving.worker --name r0 \
        --spec '{"kind": "llama_tiny", "seed": 0, "config": {...},
                 "engine": {"max_slots": 4}, "device": "cuda"}' \
        --store-root fleet/store --ckpt-root fleet/ckpt

The spec's ``device`` (default ``"cuda"``) is where the model and its
engine live; the tests pass ``"cpu"``. A worker asked for the card that
finds none fails at start-up: it never serves from the CPU instead.

The ``engine`` dict passes straight through to ``get_engine`` —
``"engine": {"spec_decode": "ngram"}`` arms speculative decoding
on the replica, and ``"engine": {"mesh_devices": 2}`` serves it
tensor-parallel (``mesh_engine.MeshGenerationEngine``): the worker
wire is topology-blind. Spec decode is failover-transparent: the
wire format (sequence snapshots) carries only verified-committed
tokens, draft state is replica-local, so a spec-on replica's exports
import into spec-off replicas (and vice versa) token-for-token.
The draft-MODEL drafter needs a live model object and therefore can't
cross the JSON spec; in-process fleets pass a
``speculative.DraftModelDrafter`` instance in ``engine_kw`` instead.

Prints ``SERVE_WORKER_READY port=<p>`` once accepting connections.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading

import torch


def build_model(spec):
    """Model builders the drill/tests use, on the spec's ``device``
    (default ``"cuda"``). ``kind: llama_tiny`` builds a tiny Llama with
    weights drawn by numpy from ``seed`` (every replica with the same
    seed holds identical weights, on any device); ``kind: import`` calls
    ``path: "pkg.mod:fn"`` with ``device=`` and the ``config`` kwargs for
    arbitrary deployments (``random_llama`` below builds a Llama of any
    width)."""
    from .. import weights
    from ..device import resolve_device
    kind = spec.get("kind", "llama_tiny")
    device = resolve_device(spec.get("device"))
    seed = int(spec.get("seed", 0))
    if kind == "llama_tiny":
        from ..models import LlamaConfig, LlamaForCausalLM
        cfg = LlamaConfig.tiny(**spec.get("config", {}))
        model = LlamaForCausalLM(cfg, device=device)
        weights.from_paddle_tpu_state(weights.random_state(model, seed),
                                      model)
    elif kind == "import":
        import importlib
        mod, _, fn = spec["path"].partition(":")
        model = getattr(importlib.import_module(mod), fn)(
            device=device, **spec.get("config", {}))
    else:
        raise ValueError(f"unknown model spec kind {kind!r}")
    model.eval()
    return model


def random_llama(device=None, seed=0, dtype="bfloat16", **config):
    """A Llama of the ``LlamaConfig`` fields given in `config` (the
    Llama-2-7B defaults for the rest) in `dtype`, its weights filled in
    place from `seed` on its device (``weights.init_random_``: the same
    seed gives the same weights on the same kind of device, in this
    process or a worker)."""
    from .. import weights
    from ..models import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM(LlamaConfig(**config), device=device,
                             dtype=getattr(torch, dtype))
    return weights.init_random_(model, seed)


def _handle_kv_verb(f, msg, replica):
    """One KV-transfer verb round trip. ``import_kv`` reads
    its sidecar frame first (the client sent header+payload back to
    back); the export verbs answer header-then-sidecar."""
    verb = msg["verb"]
    if verb == "import_kv":
        payload = f.read(int(msg["nbytes"]))
        if payload is None or len(payload) != int(msg["nbytes"]):
            return          # client vanished mid-frame: nothing to map
        pages = replica.import_kv(msg["meta"], payload,
                                  trace=msg.get("trace"))
        f.write(json.dumps({"ok": True, "pages": int(pages)})
                .encode() + b"\n")
        f.flush()
        return
    if verb == "export":
        snap, meta, payload = replica.export_sequence(
            msg["trace"], kv=bool(msg.get("kv", True)))
        head = {"snap": snap, "kv_meta": meta,
                "kv_nbytes": len(payload) if payload else 0}
    else:                   # export_kv
        meta, payload = replica.export_kv(msg["tokens"],
                                          trace=msg.get("trace"))
        head = {"kv_meta": meta,
                "kv_nbytes": len(payload) if payload else 0}
    f.write(json.dumps(head).encode() + b"\n")
    if payload:
        f.write(payload)
    f.flush()


def _handle_conn(conn, replica):
    """One sequence per connection: import the snapshot, pump tokens.
    The pump raising (engine error) turns into one error line; a client
    that disappears mid-stream just ends the thread — the engine
    finishes the sequence on its own."""
    try:
        f = conn.makefile("rwb")
        line = f.readline()
        if not line:
            return
        try:
            msg = json.loads(line)
            if msg.get("verb") in ("export", "export_kv", "import_kv"):
                # KV transfer plane: newline-JSON headers,
                # bulk page bytes as raw binary SIDECAR frames (length
                # in the header) — the snapshot stays line-shaped, the
                # pages ship once, unencoded. Errors answer as
                # structured lines like every other verb.
                try:
                    _handle_kv_verb(f, msg, replica)
                except Exception as e:  # noqa: BLE001
                    try:
                        f.write(json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}
                        ).encode() + b"\n")
                        f.flush()
                    except OSError:
                        pass
                return
            if msg.get("verb") == "ping":
                # cheap liveness probe: the supervisor's
                # quarantine path asks "does this process answer"
                # without paying a registry collection
                f.write(json.dumps(replica.ping()).encode() + b"\n")
                f.flush()
                return
            if msg.get("verb") == "doctor":
                # fleet doctor: run one detector sweep over
                # this process's registry/ring and answer the report —
                # the router's sweep sees the merge, this verb answers
                # "what does THIS replica's doctor say". Failures answer
                # structured, like the metrics verb.
                try:
                    payload = json.dumps(replica.doctor(), default=str)
                except Exception as e:  # noqa: BLE001
                    payload = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"})
                f.write(payload.encode() + b"\n")
                f.flush()
                return
            if msg.get("verb") == "cancel":
                # cancellation propagation: tear down the
                # live request carrying this fleet trace within one
                # engine step — abandoned consumer or hedge loser.
                # Idempotent: an unknown/finished trace answers
                # cancelled=false, never an error (the race where the
                # request finished first is a success, not a fault).
                try:
                    ok = replica.cancel(msg.get("trace"),
                                        reason=msg.get("reason"))
                    payload = json.dumps({"cancelled": bool(ok)})
                except Exception as e:  # noqa: BLE001
                    payload = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"})
                f.write(payload.encode() + b"\n")
                f.flush()
                return
            if msg.get("verb") == "metrics":
                # fleet metrics plane: one-line scrape of this
                # process's registry series + quantile-sketch states.
                # A scrape failure (dead engine, broken collector) must
                # answer with a structured error line like the submit
                # path does — a silent close reads as a killed worker
                try:
                    payload = json.dumps(replica.metrics(), default=str)
                except Exception as e:  # noqa: BLE001
                    payload = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"})
                f.write(payload.encode() + b"\n")
                f.flush()
                return
            pump = replica.submit(msg["snap"], int(msg.get("start", 0)))
        except (ValueError, KeyError, TypeError) as e:
            f.write(json.dumps(
                {"error": f"{type(e).__name__}: {e}"}).encode() + b"\n")
            f.flush()
            return
        try:
            for cursor, tok in pump:
                f.write(json.dumps({"cursor": int(cursor),
                                    "token": int(tok)}).encode() + b"\n")
                f.flush()
            f.write(b'{"done": true}\n')
            f.flush()
        except (BrokenPipeError, ConnectionError, OSError):
            pass
        except Exception as e:  # noqa: BLE001 — engine-side failure
            try:
                f.write(json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode()
                    + b"\n")
                f.flush()
            except OSError:
                pass
    finally:
        try:
            conn.close()
        except OSError:
            pass


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--name", required=True)
    ap.add_argument("--spec", required=True, help="model/engine spec JSON")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--store-root", default=None,
                    help="FileStore root for heartbeats")
    ap.add_argument("--ckpt-root", default=None,
                    help="checkpoint root to watch for weight swaps")
    ap.add_argument("--heartbeat-interval", type=float, default=0.2)
    ap.add_argument("--events-jsonl", default=None,
                    help="durable per-record event sink (JSONL): spans "
                         "survive a SIGKILL for tools/trace_report.py")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve a stdlib HTTP /metrics scrape endpoint "
                         "on this port (0 = ephemeral)")
    ap.add_argument("--role", default=None,
                    help="role tag for role-split routing: "
                         "'prefill' or 'decode'; omitted = serves both")
    ap.add_argument("--kv-store-root", default=None,
                    help="FileStore root of the FLEET prefix store: "
                         "LRU-evicted prefix pages spill there and "
                         "admissions refill from it, so a prompt "
                         "prefilled by any replica is a fleet-wide "
                         "prefix hit")
    ap.add_argument("--slo-targets", default=None,
                    help="JSON SLO budgets to arm IN THIS PROCESS, e.g. "
                         '\'{"ttft_ms": 250, "e2e_ms": 5000}\' — the '
                         "engine grades ttft/tpot/e2e where they are "
                         "measured, so a subprocess fleet's per-tenant "
                         "attainment gauges need the budgets armed "
                         "here, not in the router process (per-request "
                         "slo_ms still wins for TTFT)")
    args = ap.parse_args(argv)

    if args.events_jsonl:
        from ..observability.events import EVENTS
        os.makedirs(os.path.dirname(os.path.abspath(args.events_jsonl)),
                    exist_ok=True)
        EVENTS.open_sink(args.events_jsonl)
    if args.metrics_port is not None:
        from ..observability.exporters import serve_prometheus
        srv = serve_prometheus(args.metrics_port)
        print(f"SERVE_WORKER_METRICS port={srv.server_port}", flush=True)
    if args.slo_targets:
        from ..observability import tracing
        tracing.set_slo_targets(**json.loads(args.slo_targets))
    spec = json.loads(args.spec)
    model = build_model(spec)

    from .replica import LocalReplica
    store = None
    if args.store_root:
        from .store import FileStore
        store = FileStore(args.store_root)
    engine = None
    if args.kv_store_root:
        from .store import FileStore
        from .kv_transfer import PrefixStore
        engine = model.get_engine(
            prefix_store=PrefixStore(
                store=FileStore(args.kv_store_root)),
            **(spec.get("engine") or {}))
    replica = LocalReplica(
        args.name, model, engine_kw=spec.get("engine"), store=store,
        ckpt_root=args.ckpt_root,
        heartbeat_interval=args.heartbeat_interval, engine=engine,
        role=args.role)

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", args.port))
    srv.listen(64)
    port = srv.getsockname()[1]
    print(f"SERVE_WORKER_READY port={port} name={args.name} "
          f"pid={os.getpid()}", flush=True)

    # idle-path weight-swap ticks: swaps must not wait for traffic
    def ticker():
        import time as _t
        while True:
            replica.poll()
            _t.sleep(0.25)
    threading.Thread(target=ticker, daemon=True).start()

    while True:
        conn, _ = srv.accept()
        threading.Thread(target=_handle_conn, args=(conn, replica),
                         daemon=True).start()


if __name__ == "__main__":
    sys.exit(main())
