"""Sharding observatory: the counterpart of
``paddle_tpu/observability/sharding.py``. It makes the tensor-parallel
engine's communication visible, in two layers.

**Collective harvest.** The JAX package parses the post-partitioning HLO
of each compiled program for the collectives GSPMD inserted. The port has
no compiled HLO: the mesh engine issues its collectives itself, through
``distributed.parallel_base``'s program collectives, and records them
during each step program's first (eager) run, which happens anyway, the
way ``xla_introspect`` counts a program once (``record_program``). Each
op contributes its count per program run, its per-rank payload bytes (x
count) and its group size, published as in the JAX package:

- ``xla_collective_ops_total{program=,op=}``  (counter)
- ``xla_collective_bytes{program=,op=}``      (gauge, payload x count)
- ``xla_comm_fraction{program=}``             (gauge, 0..1)

``xla_comm_fraction`` is the estimated wire share of the program: the
payload scaled by the textbook per-op wire factor (2(g-1)/g for a ring
all-reduce over g ranks, ...) over a link rate (``ici_bandwidth``),
against the program's counted flops over ``perf.peak_flops``. On the card
the link rate is NVLink's; on a co-located mesh (every shard on one card)
no link is crossed and the collectives are on-device copies and adds, so
the figure used is the card's memory rate. Both tables are estimate-grade:
the fraction ranks programs and tracks trajectory, it does not clock
wires. ``parse_hlo_collectives`` / ``parse_hlo_param_shardings`` are
kept, copied as they are, for HLO text from the JAX package's dumps.

**Partition intent-vs-reality audit.** ``partition_audit(engine)``
compares the canonical ``mesh_engine.param_spec`` of every parameter with
the layout its placed pieces actually hold, so a silently replicated
"column-parallel" weight is a named finding: the
``sharding_partition_violations`` gauge and ``partition_violation``
events carrying (param, declared, actual). ``hlo_params`` sums the
harvested programs' placed-parameter counts (sharded, replicated).

Downstream, as in the JAX package: ``detectors.CollectiveRegression``
watches the violations gauge and the mesh engine's
``xla_collective_dispatch_bytes_total``; ``obs.reset()`` clears the
harvest and the audits.
"""

from __future__ import annotations

import collections
import re
import threading

from .metrics import REGISTRY as _REG, _ENABLED
from .events import EVENTS as _EVENTS

__all__ = [
    "COLLECTIVE_OPS", "ICI_BYTES_PER_S", "HBM_BYTES_PER_S", "ici_bandwidth",
    "parse_hlo_collectives", "parse_hlo_param_shardings", "record_program",
    "record_harvest", "collective_summary", "collective_bytes_of",
    "comm_fraction_of", "partition_audit", "last_audit", "reset",
]

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "collective-permute", "all-to-all")

# estimated WIRE traffic per rank as a multiple of the payload, by group
# fan-out g: ring all-reduce moves each byte twice minus the local shard,
# gather/scatter families move everything but the local shard, a permute
# forwards the payload once
_WIRE_FACTOR = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g if g > 1 else 0.0,
    "all-gather": lambda g: (g - 1) / g if g > 1 else 0.0,
    "reduce-scatter": lambda g: (g - 1) / g if g > 1 else 0.0,
    "all-to-all": lambda g: (g - 1) / g if g > 1 else 0.0,
    "collective-permute": lambda g: 1.0 if g > 1 else 0.0,
}

# nominal per-card link rate (bytes/s, one direction) by device kind,
# substring-matched against the normalized device name as
# perf.PEAK_FLOPS is: the JAX package's TPU ICI entries, then the H100's
# NVLink (NVIDIA's data sheets: the SXM card's 900 GB/s total is 450 GB/s
# a direction; the PCIe card's NVLink bridge 600 GB/s, 300 a direction);
# "cpu" is a nominal stand-in so CPU meshes publish finite fractions
ICI_BYTES_PER_S = {
    "v5e": 200e9, "v5litepod": 200e9, "v5lite": 200e9,
    "v5p": 600e9, "v6e": 448e9, "v6lite": 448e9, "v4": 300e9,
    "h100pcie": 300e9, "h100": 450e9,
    "cpu": 10e9,
}

# a co-located mesh crosses no link: its collectives are copies and adds
# in the card's memory (NVIDIA's data sheets: 3.35 TB/s HBM3 on the SXM
# card, 2.0 TB/s HBM2e on the PCIe card); the same nominal cpu entry
HBM_BYTES_PER_S = {"h100pcie": 2.0e12, "h100": 3.35e12, "cpu": 10e9}

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "f32": 4, "s32": 4, "u32": 4,
    "f64": 8, "s64": 8, "u64": 8, "c64": 8, "c128": 16,
}

_MAX_PROGRAMS = 512          # mirror xla_introspect's cardinality bound
_LOCK = threading.Lock()
_HARVEST = collections.OrderedDict()   # program -> entry dict
_AUDITS = []                            # partition_audit results, newest last

# one defining instruction per HLO line: `%name = SHAPE op(...)`; the
# shape text between `=` and the op name may be a single buffer or a
# tuple (async -start pairs)
_COLL_RE = re.compile(
    r"=\s*(?P<shape>[^=]*?)\s*"
    r"\b(?P<op>all-reduce|all-gather|reduce-scatter|collective-permute|"
    r"all-to-all)(?P<variant>-start|-done)?\(")
_BUF_RE = re.compile(
    r"\b(?P<dt>pred|bf16|f16|f32|f64|f8e4m3fn|f8e5m2|f8e4m3b11fnuz|"
    r"s4|s8|s16|s32|s64|u4|u8|u16|u32|u64|c64|c128)\[(?P<dims>[0-9,]*)\]")
# replica_groups: legacy `{{0,1},{2,3}}` or V2 iota
# `[num_groups,group_size]<=[n]`
_GROUPS_V2_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")
_GROUPS_V1_RE = re.compile(r"replica_groups=\{\{([0-9, ]*)\}")
_NPART_RE = re.compile(r"\bnum_partitions=(\d+)")
_PARAM_SHARDING_RE = re.compile(
    r"=[^=\n]*\bparameter\(\d+\)[^\n]*sharding=\{(replicated|devices)")


def _buf_bytes(shape_text):
    """Largest single buffer (bytes) among the dtype[dims] specs in an
    instruction's result-shape text: the collective's per-device payload.
    For async -start tuples (operand alias + result) the max picks the
    moved buffer without double-counting the alias."""
    best = 0
    for m in _BUF_RE.finditer(shape_text):
        n = _DTYPE_BYTES.get(m.group("dt"), 4)
        for d in m.group("dims").split(","):
            if d.strip():
                n *= int(d)
        best = max(best, n)
    return best


def _group_size(line, default):
    m = _GROUPS_V2_RE.search(line)
    if m:
        return max(1, int(m.group(2)))
    m = _GROUPS_V1_RE.search(line)
    if m:
        return max(1, len([x for x in m.group(1).split(",") if x.strip()]))
    return max(1, int(default))


def parse_hlo_collectives(text, default_group=None):
    """{op: {"count", "bytes", "max_group"}} from post-partitioning HLO
    text. ``bytes`` is per-device payload x static count; async
    ``-start`` halves count as the op, ``-done`` halves are skipped."""
    if default_group is None:
        m = _NPART_RE.search(text or "")
        default_group = int(m.group(1)) if m else 1
    out = {}
    for line in (text or "").splitlines():
        m = _COLL_RE.search(line)
        if m is None or m.group("variant") == "-done":
            continue
        op = m.group("op")
        payload = _buf_bytes(m.group("shape"))
        g = _group_size(line, default_group)
        e = out.setdefault(op, {"count": 0, "bytes": 0, "max_group": 1})
        e["count"] += 1
        e["bytes"] += payload
        e["max_group"] = max(e["max_group"], g)
    return out


def parse_hlo_param_shardings(text):
    """(sharded, replicated) counts of entry-parameter sharding
    annotations — the compiler's own statement of which inputs it laid
    out across devices."""
    sharded = replicated = 0
    for m in _PARAM_SHARDING_RE.finditer(text or ""):
        if m.group(1) == "devices":
            sharded += 1
        else:
            replicated += 1
    return sharded, replicated


def _platform():
    try:
        import torch
        return torch.cuda.get_device_name() if torch.cuda.is_available() \
            else "cpu"
    except Exception:  # noqa: BLE001 — no backend: nominal cpu
        return "cpu"


def ici_bandwidth(platform=None, co_located=False):
    """Link bytes/s for a platform string (None: the local card's name,
    as perf.peak_flops reads it; the nominal cpu entry without one). With
    co_located, the card's memory rate: the figure a mesh whose shards
    share one card moves its collective bytes at."""
    if platform is None:
        platform = _platform()
    table = HBM_BYTES_PER_S if co_located else ICI_BYTES_PER_S
    key = str(platform).lower().replace(" ", "")
    for k, v in table.items():
        if k in key:
            return v
    return table["cpu"]


# -- harvest ----------------------------------------------------------------

def record_harvest(name, collectives, flops=None, params_sharded=0,
                   params_replicated=0, platform=None, co_located=False):
    """Publish one program's collective accounting into the registry and
    the harvest store. ``collectives``: {op: {count, bytes, max_group}}.
    Also the injection point for tests/tools (no program needed)."""
    wire = 0.0
    total = 0
    for op, e in collectives.items():
        count = int(e.get("count", 0))
        nbytes = int(e.get("bytes", 0))
        g = int(e.get("max_group", 1))
        total += nbytes
        wire += nbytes * _WIRE_FACTOR.get(op, lambda _g: 1.0)(g)
        _REG.counter("xla_collective_ops_total",
                     "collective instructions in the compiled program",
                     labels={"program": name, "op": op}).inc(count)
        _REG.gauge("xla_collective_bytes",
                   "per-device collective payload bytes in the compiled "
                   "program (payload x static count)",
                   labels={"program": name, "op": op}).set(float(nbytes))
    frac = None
    bw = ici_bandwidth(platform, co_located)
    comm_s = wire / bw if bw else 0.0
    compute_s = (float(flops) / _peak()) if flops else 0.0
    if comm_s or compute_s:
        frac = comm_s / (comm_s + compute_s) if (comm_s + compute_s) \
            else 0.0
        _REG.gauge("xla_comm_fraction",
                   "estimated wire share of the program's modeled step "
                   "time (nominal ICI-BW vs PEAK_FLOPS tables)",
                   labels={"program": name}).set(round(frac, 6))
    entry = {"ops": {op: dict(e) for op, e in collectives.items()},
             "count": sum(int(e.get("count", 0))
                          for e in collectives.values()),
             "bytes": total, "wire_bytes": int(wire),
             "comm_fraction": frac, "flops": flops,
             "params_sharded": int(params_sharded),
             "params_replicated": int(params_replicated)}
    with _LOCK:
        while len(_HARVEST) >= _MAX_PROGRAMS:
            _HARVEST.popitem(last=False)
        _HARVEST[name] = entry
    return entry


def _peak():
    from . import perf
    return perf.peak_flops() or perf.PEAK_FLOPS["cpu"]


def record_program(name, collectives, flops=None, params_sharded=0,
                   params_replicated=0, co_located=False):
    """The collectives one step program issued in its first run (the
    counterpart of ``harvest_compiled``): published by ``record_harvest``
    unless telemetry is off or the program was harvested already (the
    first program of a label is the one counted, as in xla_introspect).
    Never raises: comm introspection is additive to the run."""
    if not _ENABLED[0]:
        return None
    with _LOCK:
        if name in _HARVEST:
            return None
    try:
        return record_harvest(name, collectives, flops=flops,
                              params_sharded=params_sharded,
                              params_replicated=params_replicated,
                              co_located=co_located)
    except Exception as e:  # noqa: BLE001 — never break the run
        _EVENTS.record("sharding_harvest_error", program=name,
                       error=f"{type(e).__name__}: {str(e)[:160]}")
        return None


def collective_summary():
    """{program: harvest entry} snapshot (copies)."""
    with _LOCK:
        return {n: {k: (dict(v) if isinstance(v, dict) else v)
                    for k, v in e.items()} for n, e in _HARVEST.items()}


def collective_bytes_of(name):
    """Harvested per-device collective payload bytes of one program
    (0 when unharvested): the mesh engine's per-dispatch estimate."""
    with _LOCK:
        e = _HARVEST.get(name)
    return int(e["bytes"]) if e else 0


def comm_fraction_of(name):
    with _LOCK:
        e = _HARVEST.get(name)
    return e.get("comm_fraction") if e else None


# -- partition intent-vs-reality audit --------------------------------------

def _norm_spec(spec):
    """PartitionSpec -> canonical tuple with trailing Nones stripped, so
    P(), P(None) and P(None, None) (all fully replicated) compare equal."""
    t = tuple(spec) if spec is not None else ()
    while t and t[-1] is None:
        t = t[:-1]
    return t


def _has_axis(entry, axis):
    if entry is None:
        return False
    if isinstance(entry, (tuple, list)):
        return axis in entry
    return entry == axis


def partition_audit(engine, publish=True):
    """Compare every parameter's DECLARED ``param_spec`` PartitionSpec
    against the layout its placed pieces actually hold (a single-device
    engine's parameters hold none). Returns

        {ok, checked, sharded, replicated, violations: [{param,
         declared, actual}], col_parallel_ok, row_parallel_ok,
         proof: {col_parallel: {param: bool}, row_parallel: {...}},
         hlo_params: {sharded, replicated} | None}

    and (publish=True) sets the ``sharding_partition_violations`` gauge
    and records ``partition_violation`` / ``partition_audit`` events —
    the CollectiveRegression tripwire and run_diff's evidence."""
    from ..serving.mesh_engine import (param_spec, _COL_SUFFIXES,
                                       _ROW_SUFFIXES)
    names = list(engine._param_names)
    placed = engine._param_vals()
    tp = getattr(engine, "_tp", 1)
    fsdp = getattr(engine, "_fsdp", 1)
    violations = []
    sharded = replicated = 0
    proof = {"col_parallel": {}, "row_parallel": {}}
    for name, arr in zip(names, placed):
        declared = param_spec(name, tuple(getattr(arr, "shape", ())),
                              tp, fsdp)
        actual = arr.actual_spec() if hasattr(arr, "actual_spec") else None
        da, aa = _norm_spec(declared), _norm_spec(actual)
        if any(ax is not None for ax in aa):
            sharded += 1
        else:
            replicated += 1
        if name.endswith(_COL_SUFFIXES):
            proof["col_parallel"][name] = \
                len(aa) >= 2 and _has_axis(aa[1], "tp")
        elif name.endswith(_ROW_SUFFIXES):
            proof["row_parallel"][name] = \
                len(aa) >= 1 and _has_axis(aa[0], "tp")
        if da != aa:
            violations.append({
                "param": name,
                "declared": str(tuple(declared)),
                "actual": str(tuple(actual) if actual is not None
                              else None)})
    # corroborating compiler-side evidence: parameter sharding
    # annotations from any harvested engine program
    hlo_params = None
    with _LOCK:
        for prog, e in _HARVEST.items():
            if not prog.startswith("engine:"):
                continue
            if hlo_params is None:
                hlo_params = {"sharded": 0, "replicated": 0}
            hlo_params["sharded"] += e.get("params_sharded", 0)
            hlo_params["replicated"] += e.get("params_replicated", 0)
    out = {
        "ok": not violations,
        "checked": len(names),
        "sharded": sharded,
        "replicated": replicated,
        "violations": violations,
        "col_parallel_ok": bool(proof["col_parallel"])
        and all(proof["col_parallel"].values()),
        "row_parallel_ok": bool(proof["row_parallel"])
        and all(proof["row_parallel"].values()),
        "proof": proof,
        "hlo_params": hlo_params,
    }
    if publish and _ENABLED[0]:
        _REG.gauge("sharding_partition_violations",
                   "params whose placed sharding contradicts the "
                   "declared param_spec (intent-vs-reality audit)"
                   ).set(float(len(violations)))
        for v in violations[:8]:
            _EVENTS.record("partition_violation", **v)
        _EVENTS.record("partition_audit", checked=len(names),
                       violations=len(violations), sharded=sharded,
                       replicated=replicated,
                       col_parallel_ok=out["col_parallel_ok"],
                       row_parallel_ok=out["row_parallel_ok"])
    _AUDITS.append(out)
    del _AUDITS[:-16]
    return out


def last_audit():
    return _AUDITS[-1] if _AUDITS else None


def reset():
    """Forget every harvested program and audit (test isolation — wired
    into obs.reset() like xla_introspect.reset())."""
    with _LOCK:
        _HARVEST.clear()
    del _AUDITS[:]
