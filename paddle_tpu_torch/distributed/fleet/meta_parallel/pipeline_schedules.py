"""Static pipeline schedules: a copy of the JAX package's pure-Python
``fleet/meta_parallel/pipeline_schedules.py`` (FThenB / 1F1B / the
interleaved VPP schedule / ZBH1, after the reference's
``pipeline_scheduler_pass`` and ``pipeline_parallel.py:575, :1174``).

Each generator returns, per physical stage, the ordered list of schedule
steps ("F", micro, chunk) / ("B", micro, chunk) (and ("W", micro, chunk)
for ZBH1's deferred weight gradients). ``PipelineParallelWithInterleave``
issues its work in ``interleaved_1f1b``'s order, and ``simulate_bubble``
replays a schedule tick by tick: the plain 1F1B bubble fraction is
(S-1)/(m+S-1), the interleaved one (S-1)/(V*m+S-1).
"""

from __future__ import annotations


def f_then_b(n_micro, n_stages):
    """All forwards, then all backwards (ref FThenB pass)."""
    out = []
    for s in range(n_stages):
        steps = [("F", k, 0) for k in range(n_micro)]
        steps += [("B", k, 0) for k in range(n_micro)]
        out.append(steps)
    return out


def one_f_one_b(n_micro, n_stages):
    """Canonical 1F1B (ref pipeline_parallel.py:575): stage s runs
    (n_stages - s) warmup forwards, then alternates."""
    out = []
    for s in range(n_stages):
        warmup = min(n_stages - s, n_micro)
        steps = [("F", k, 0) for k in range(warmup)]
        fk, bk = warmup, 0
        while bk < n_micro:
            steps.append(("B", bk, 0))
            bk += 1
            if fk < n_micro:
                steps.append(("F", fk, 0))
                fk += 1
        out.append(steps)
    return out


def _vpp_unit(i, n_stages, n_virtual, forward):
    """Map a virtual step index to (microbatch, model_chunk) — the classic
    Megatron interleave: groups of n_stages microbatches sweep chunk 0, then
    chunk 1, ... before the next group; backward sweeps chunks reversed."""
    group = i // (n_stages * n_virtual)
    r = i % (n_stages * n_virtual)
    v = r // n_stages
    if not forward:
        v = n_virtual - 1 - v
    k = group * n_stages + (r % n_stages)
    return k, v


def interleaved_1f1b(n_micro, n_stages, n_virtual):
    """Interleaved VPP (ref PipelineParallelWithInterleave :1174).

    Stage s owns model chunk v as global chunk c = v*n_stages + s. Warmup
    per stage = (S-s-1)*2 + (V-1)*S chunk-forwards (Megatron), then 1F1B on
    chunk units, then cooldown backwards.
    """
    if n_micro % n_stages:
        raise ValueError(
            f"interleaved schedule needs micro-batches ({n_micro}) divisible"
            f" by stages ({n_stages})")
    total = n_micro * n_virtual   # chunk-units per stage
    out = []
    for s in range(n_stages):
        warmup = min((n_stages - s - 1) * 2 + (n_virtual - 1) * n_stages,
                     total)
        steps = []
        for i in range(warmup):
            k, v = _vpp_unit(i, n_stages, n_virtual, True)
            steps.append(("F", k, v))
        for i in range(warmup, total):
            k, v = _vpp_unit(i, n_stages, n_virtual, True)
            steps.append(("F", k, v))
            kb, vb = _vpp_unit(i - warmup, n_stages, n_virtual, False)
            steps.append(("B", kb, vb))
        for i in range(total - warmup, total):
            kb, vb = _vpp_unit(i, n_stages, n_virtual, False)
            steps.append(("B", kb, vb))
        out.append(steps)
    return out


def zero_bubble_h1(n_micro, n_stages):
    """ZBH1 (ref pipeline_scheduler_pass ZBH1): split backward into
    activation-grad (Bx) and weight-grad (Bw); weight grads fill the tail
    bubble. Modeled here as ("B", k, 0) then deferred ("W", k, 0) steps."""
    base = one_f_one_b(n_micro, n_stages)
    out = []
    for s, steps in enumerate(base):
        zb = []
        deferred = []
        for step in steps:
            if step[0] == "B":
                zb.append(("B", step[1], 0))
                deferred.append(("W", step[1], 0))
                # weight grad scheduled as soon as a bubble would appear:
                # tail bubbles are filled below
            else:
                zb.append(step)
        zb.extend(deferred)
        out.append(zb)
    return out


def simulate_bubble(schedules, n_stages, f_cost=1.0, b_cost=1.0,
                    w_cost=0.0):
    """Tick simulation honoring cross-stage dependencies.

    ("F", k, v) on stage s needs ("F", k, v') done on stage s-1 where
    (v', s-1) is the previous chunk; ("B", k, v) needs the downstream
    backward. Returns (makespan, total_idle, bubble_fraction).
    """
    cost = {"F": f_cost, "B": b_cost, "W": w_cost}
    # map chunk v on stage s -> global chunk index c = v * n_stages + s
    n_virtual = 1 + max((st[2] for sched in schedules for st in sched),
                        default=0)
    last_chunk = n_virtual * n_stages - 1
    done = {}           # (kind, k, global_chunk) -> finish time
    time_s = [0.0] * n_stages
    idx = [0] * n_stages
    total = sum(len(s) for s in schedules)
    executed = 0
    while executed < total:
        progressed = False
        for s in range(n_stages):
            if idx[s] >= len(schedules[s]):
                continue
            kind, k, v = schedules[s][idx[s]]
            c = v * n_stages + s
            # dependency
            if kind == "F":
                dep = None if c == 0 else ("F", k, c - 1)
            elif kind == "B":
                dep = (("F", k, last_chunk) if c == last_chunk
                       else ("B", k, c + 1))
            else:   # W depends on local B
                dep = ("B", k, c)
            if dep is not None and dep not in done:
                continue
            start = max(time_s[s], done[dep] if dep else 0.0)
            finish = start + cost[kind]
            done[(kind, k, c)] = finish
            time_s[s] = finish
            idx[s] += 1
            executed += 1
            progressed = True
        if not progressed:
            raise RuntimeError("schedule deadlock")
    makespan = max(time_s)
    busy = [sum(cost[st[0]] for st in sched) for sched in schedules]
    idle = sum(makespan - b for b in busy)
    return makespan, idle, idle / (makespan * n_stages)
