"""The port's sharding observatory (``paddle_tpu_torch.observability.
sharding``): the counterparts of the six tests of
``tests/test_sharding_obs.py``, held to the JAX package.

- the HLO text parsers, copied as they are, give the JAX package's
  results on the same text;
- ``record_harvest`` publishes the same series and the same wire math
  (the port's nominal cpu link rate and peak);
- a conforming tp2 mesh engine on the CPU: its programs' collectives are
  harvested at their first run under ``:tp2`` labels with all-reduce
  bytes, the partition audit is green with the canonical layout proven,
  a repeat drain builds nothing and harvests the same, mesh dispatches
  land in the flight recorder and the dispatch-bytes counter, the JAX
  package's ``tools/obs_report.py`` renders the port's dump GREEN, and
  ``obs.reset()`` forgets it all;
- a misspecified override (``q_proj.weight`` replicated): the audit is
  RED and names the parameter, CollectiveRegression fires once, the JAX
  package's ``tools/run_diff.py`` ranks ``comm_regression`` first (rc 1;
  A vs A rc 0), and obs_report renders RED.

Tolerance: exact, apart from the comm fraction (1e-3 relative, as the JAX
test).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.observability import sharding as jsharding

import paddle_tpu_torch.observability as obs
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import flight_recorder as fr
from paddle_tpu_torch.observability import sharding
from paddle_tpu_torch.observability import xla_introspect as xi
from paddle_tpu_torch.observability.doctor import Doctor
from paddle_tpu_torch.observability.events import EVENTS
from paddle_tpu_torch.observability.metrics import REGISTRY
from paddle_tpu_torch.serving.mesh_engine import MeshGenerationEngine

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import obs_report  # noqa: E402
import run_diff  # noqa: E402

torch.set_num_threads(1)

CFG = dict(vocab=128, hidden=32, layers=2, heads=4, kv_heads=2, ffn=64,
           seq=128)
KW = dict(max_slots=4, page_size=8, max_seq_len=128, prefill_chunk=16)
_RNG = np.random.default_rng(19)
PROMPT = _RNG.integers(1, 127, (13,)).astype(np.int32)


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset()
    yield
    fr.disable_flight_recorder()
    obs.reset()


def _mesh(overrides=None, seed=0):
    model = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    weights.init_random_(model, seed=seed)
    return MeshGenerationEngine(model, mesh_devices=2,
                                param_spec_overrides=overrides, **KW)


def _drain(eng, tok=5):
    rid = eng.add_request(PROMPT, max_new_tokens=tok)
    return eng.run()[rid]


def _traces(e):
    return (e.decode_trace_count, e.prefill_trace_count,
            e.ragged_trace_count, e.copy_trace_count,
            e.upload_trace_count, e.spec_trace_count)


# ---------------------------------------------------------------------------
# HLO parsing (pure text; the JAX package's text, copied)
# ---------------------------------------------------------------------------

HLO = """\
HloModule jit_step, num_partitions=2

ENTRY %main (p0: f32[8,16], p1: f32[4]) -> f32[8,16] {
  %p0 = f32[8,16]{1,0} parameter(0), sharding={devices=[2,1]<=[2]}
  %p1 = f32[4]{0} parameter(1), sharding={replicated}
  %ar = f32[8,16]{1,0} all-reduce(%p0), channel_id=1, replica_groups=[1,2]<=[2], use_global_device_ids=true, to_apply=%add
  %cp = f32[8,16]{1,0} collective-permute(%ar), channel_id=2, source_target_pairs={{0,1},{1,0}}
  %ags = (bf16[4,8]{1,0}, bf16[8,8]{1,0}) all-gather-start(%x), channel_id=3, replica_groups={{0,1}}, dimensions={0}
  %agd = bf16[8,8]{1,0} all-gather-done(%ags)
  %rs = s8[4,16]{1,0} reduce-scatter(%y), replica_groups=[2,1]<=[2], dimensions={0}, to_apply=%add
}
"""


def test_parse_hlo_collectives_counts_bytes_groups():
    got = sharding.parse_hlo_collectives(HLO)
    assert got == jsharding.parse_hlo_collectives(HLO)
    assert got["all-reduce"] == {"count": 1, "bytes": 512, "max_group": 2}
    assert got["collective-permute"] == {"count": 1, "bytes": 512,
                                         "max_group": 2}
    assert got["all-gather"] == {"count": 1, "bytes": 128, "max_group": 2}
    assert got["reduce-scatter"] == {"count": 1, "bytes": 64,
                                     "max_group": 1}
    assert "all-to-all" not in got


def test_parse_hlo_param_shardings():
    assert sharding.parse_hlo_param_shardings(HLO) == \
        jsharding.parse_hlo_param_shardings(HLO) == (1, 1)
    assert sharding.parse_hlo_param_shardings("") == (0, 0)


def test_parse_hlo_collectives_empty_and_default_group():
    assert sharding.parse_hlo_collectives("") == {}
    line = "  %ar = f32[4]{0} all-reduce(%x), to_apply=%add\n"
    one = sharding.parse_hlo_collectives(line, default_group=4)
    assert one == jsharding.parse_hlo_collectives(line, default_group=4)
    assert one["all-reduce"]["max_group"] == 4


def test_record_harvest_publishes_and_wire_math():
    sharding.record_harvest(
        "prog:a", {"all-reduce": {"count": 3, "bytes": 3000,
                                  "max_group": 2}},
        flops=1e9, platform="cpu")
    snap = REGISTRY.snapshot()
    assert snap["counters"][
        "xla_collective_ops_total{op=all-reduce,program=prog:a}"] == 3
    assert snap["gauges"][
        "xla_collective_bytes{op=all-reduce,program=prog:a}"] == 3000
    frac = snap["gauges"]["xla_comm_fraction{program=prog:a}"]
    comm_s = 3000.0 / sharding.ICI_BYTES_PER_S["cpu"]
    compute_s = 1e9 / sharding._peak()
    assert frac == pytest.approx(comm_s / (comm_s + compute_s), rel=1e-3)
    assert sharding.ICI_BYTES_PER_S["cpu"] == \
        jsharding.ICI_BYTES_PER_S["cpu"]
    assert sharding.collective_bytes_of("prog:a") == 3000
    assert sharding.collective_bytes_of("prog:missing") == 0
    entry = sharding.collective_summary()["prog:a"]
    assert entry["wire_bytes"] == 3000 and entry["count"] == 3
    # the link figures: NVLink by the card's name, its memory rate for a
    # co-located mesh
    assert sharding.ici_bandwidth("NVIDIA H100 80GB HBM3") == 450e9
    assert sharding.ici_bandwidth("NVIDIA H100 80GB HBM3",
                                  co_located=True) == 3.35e12
    assert sharding.ici_bandwidth("NVIDIA H100 PCIe") == 300e9


# ---------------------------------------------------------------------------
# conforming mesh: harvest + stability + green audit + flight + reset
# ---------------------------------------------------------------------------

def test_conforming_mesh_observatory(tmp_path):
    eng = _mesh()
    _drain(eng)
    _drain(eng)     # the second drain settles the prefix-cache path split
    xi.harvest()

    summ = sharding.collective_summary()
    progs = [n for n in summ if n.startswith("engine:")]
    assert progs and all(n.endswith(":tp2") for n in progs), progs
    assert any(summ[n]["ops"].get("all-reduce", {}).get("bytes", 0) > 0
               for n in progs), summ
    assert all(summ[n]["flops"] and summ[n]["comm_fraction"]
               for n in progs)

    audit = sharding.partition_audit(eng)
    assert audit["ok"] and not audit["violations"]
    assert audit["col_parallel_ok"] and audit["row_parallel_ok"]
    assert audit["sharded"] > 0
    assert audit["hlo_params"] and audit["hlo_params"]["sharded"] > 0
    assert sharding.last_audit() is audit

    t0 = _traces(eng)
    _drain(eng)
    xi.harvest()
    assert _traces(eng) == t0, "repeat drain built programs"
    summ2 = sharding.collective_summary()
    assert {n: summ2[n]["ops"] for n in progs} == \
        {n: summ[n]["ops"] for n in progs}

    rec = fr.enable_flight_recorder(rank=0, world=1)
    _drain(eng)
    md = [e for e in rec.entries() if e["op"] == "mesh_dispatch"]
    assert md, "mesh dispatches missing from the flight ring"
    assert any(e["bytes"] > 0 for e in md)
    assert all(e["end_us"] is not None for e in md)
    assert REGISTRY.snapshot()["counters"].get(
        "xla_collective_dispatch_bytes_total", 0) > 0

    prefix = str(tmp_path / "green")
    obs.dump_run(prefix)
    text = obs_report.render(
        json.load(open(f"{prefix}.metrics.json")),
        obs_report.load_events(f"{prefix}.events.jsonl"))
    assert "[sharding]" in text
    assert "all-reduce" in text
    assert "partition audit: GREEN" in text
    assert "comm fraction" in text

    obs.reset()
    assert sharding.collective_summary() == {}
    assert sharding.last_audit() is None
    snap = REGISTRY.snapshot()
    assert all(v == 0 for k, v in snap["counters"].items()
               if k.startswith("xla_collective_"))
    assert not snap["gauges"].get("sharding_partition_violations")


# ---------------------------------------------------------------------------
# mis-specced mesh: named RED audit -> detector -> run_diff -> report
# ---------------------------------------------------------------------------

def test_misspec_mesh_red_audit_and_triage(tmp_path):
    def dump(overrides, prefix):
        obs.reset()
        eng = _mesh(overrides=overrides)
        _drain(eng)
        xi.harvest()
        audit = sharding.partition_audit(eng)
        obs.dump_run(str(tmp_path / prefix))
        return eng, audit

    _, good = dump(None, "a")
    eng, bad = dump({"q_proj.weight": None}, "b")

    assert good["ok"]
    assert not bad["ok"] and not bad["col_parallel_ok"]
    names = [v["param"] for v in bad["violations"]]
    assert "llama.layers.0.self_attn.q_proj.weight" in names
    v0 = bad["violations"][0]
    assert "tp" in v0["declared"] and v0["actual"] == "()"
    assert any(e.get("param") == v0["param"]
               for e in EVENTS.events("partition_violation"))
    # the override computes the same tokens (a layout, not a result)
    assert list(_drain(eng)) == list(_drain(_mesh()))

    obs.reset()
    doctor = Doctor(name="comm")
    doctor.observe()
    sharding.partition_audit(eng)
    findings = [f for f in doctor.observe()
                if f["finding"] == "comm_regression"]
    assert findings, "replicated-param tripwire did not fire"
    assert v0["param"] in findings[0]["summary"]
    assert not [f for f in doctor.observe()
                if f["finding"] == "comm_regression"]

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    rows = run_diff.diff_runs(run_diff.load_run(a), run_diff.load_run(b))
    assert rows and rows[0]["cause"] == "comm_regression"
    assert v0["param"] in rows[0]["detail"]
    assert rows[0]["evidence"]["violations_new"] >= 1
    assert run_diff.main([a, b, "--check"]) == 1
    assert run_diff.main([a, a, "--check"]) == 0

    text = obs_report.render(
        json.load(open(f"{b}.metrics.json")),
        obs_report.load_events(f"{b}.events.jsonl"))
    assert "partition audit: RED" in text
    assert f"VIOLATION {v0['param']}" in text
