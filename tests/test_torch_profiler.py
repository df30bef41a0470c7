"""The port's profiler (``paddle_tpu_torch/profiler``) against the JAX
package's (``paddle_tpu/profiler``).

- ``make_scheduler`` (every phase argument, ``repeat``, ``skip_first``)
  and the ``(start, end)`` tuple form give the same state for every
  step as JAX's;
- a ``Profiler`` driven over the same steps walks the same states, fires
  ``on_trace_ready`` at the same steps and buffers host ``RecordEvent``
  spans only while a window records, as JAX's does (the port's with
  ``torch.profiler`` running underneath, JAX's timer-only);
- the spans, from every thread, export through ``Profiler.export`` (with
  the window's torch events: the spans also stand there as
  ``record_function`` ranges) and merge into
  ``observability.chrome_trace()``; ``load_profiler_result`` reads an
  export back; ``summary`` prints the span table.
"""

import json
import threading

import pytest
import torch

from paddle_tpu import profiler as jprof

import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch import profiler as tprof

SCHEDULES = [dict(), dict(closed=1, ready=1, record=2),
             dict(closed=2, ready=0, record=1, repeat=2),
             dict(closed=0, ready=2, record=3, skip_first=3),
             dict(closed=1, ready=1, record=1, repeat=1, skip_first=1)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: str(kw) or "default")
def test_make_scheduler_states_equal_jax(kw):
    js, ts = jprof.make_scheduler(**kw), tprof.make_scheduler(**kw)
    assert [ts(i) for i in range(40)] == [js(i) for i in range(40)]


def test_scheduler_refusals_and_tuple_form():
    for bad in (dict(record=0), dict(closed=-1)):
        with pytest.raises(ValueError):
            tprof.make_scheduler(**bad)
    js, ts = jprof._tuple_scheduler(2, 5), tprof._tuple_scheduler(2, 5)
    assert [ts(i) for i in range(8)] == [js(i) for i in range(8)]


def _drive(mod, scheduler, n, **kw):
    """States per step, the steps at which on_trace_ready fired and the
    span names buffered when it did."""
    fired = []
    p = mod.Profiler(scheduler=scheduler, on_trace_ready=lambda pr: fired.append(
        (pr._step, sorted({e["name"] for e in mod._host.all_events()}))),
        **kw)
    states = []
    p.start()
    for i in range(n):
        states.append(p._state)
        with mod.RecordEvent(f"step{i}"):
            torch.ones(4) @ torch.ones(4)
        p.step()
    p.stop()
    return states, fired


@pytest.mark.parametrize("scheduler", [
    dict(closed=1, ready=1, record=2, repeat=1),
    dict(closed=1, ready=1, record=2),
    (1, 3)], ids=["repeat1", "forever", "tuple"])
def test_profiler_walks_the_jax_states(scheduler):
    def sch(mod):
        return tuple(scheduler) if isinstance(scheduler, tuple) \
            else mod.make_scheduler(**scheduler)
    want = _drive(jprof, sch(jprof), 9, timer_only=True)
    got = _drive(tprof, sch(tprof), 9)
    assert got == want
    assert got[1], "no window closed"


def test_spans_export_and_merge_into_chrome_trace(tmp_path):
    tobs.reset()
    tobs.EVENTS.record("t_mark", note="between spans")
    out = {}

    def ready(pr):
        out["doc"] = pr.export(str(tmp_path / "trace.json"))
        out["merged"] = tobs.chrome_trace()
        out["summary"] = pr.summary()

    p = tprof.Profiler(scheduler=tprof.make_scheduler(closed=1, ready=1,
                                                      record=2, repeat=1),
                       on_trace_ready=ready)
    p.start()
    for i in range(5):
        with tprof.RecordEvent(f"train_step_{i}"):
            th = threading.Thread(target=lambda i=i: tprof.RecordEvent(
                f"loader_{i}").__enter__().end())
            th.start()
            th.join()
            torch.randn(16, 16) @ torch.randn(16, 16)
        p.step()
    p.stop()
    doc = out["doc"]
    names = [e.get("name") for e in doc["traceEvents"]]
    for want in ("train_step_2", "train_step_3", "loader_2", "loader_3"):
        assert want in names
    assert "train_step_1" not in names and "train_step_4" not in names
    # the spans are record_function ranges in torch's own events too
    assert sum(1 for e in doc["traceEvents"]
               if e.get("name") == "train_step_2") >= 2
    assert "t_mark" in names                        # observability marks
    merged = [e.get("name") for e in out["merged"]["traceEvents"]]
    assert "train_step_2" in merged and "loader_3" in merged
    assert "t_mark" in merged
    assert "train_step_3" in out["summary"]
    back = tprof.load_profiler_result(str(tmp_path / "trace.json"))
    assert any(e.get("name") == "train_step_3" for e in back)
    assert json.load(open(tmp_path / "trace.json"))["traceEvents"]


def test_export_chrome_tracing_handler_and_guard(tmp_path):
    with tprof.profiler_guard(on_trace_ready=tprof.export_chrome_tracing(
            str(tmp_path / "out"))) as p:
        with tprof.RecordEvent("whole"):
            torch.ones(3).sum()
    assert isinstance(p, tprof.Profiler)
    doc = json.load(open(tmp_path / "out" / "host_trace.json"))
    assert any(e.get("name") == "whole" for e in doc["traceEvents"])
    assert tprof.SortedKeys.CPUTotal.value == jprof.SortedKeys.CPUTotal.value
    assert [v.name for v in tprof.SummaryView] == \
        [v.name for v in jprof.SummaryView]
