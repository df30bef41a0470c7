"""The port's step-scope performance ledger and program introspection
(``paddle_tpu_torch/observability/perf.py``, ``xla_introspect.py``)
against the JAX package's.

- ``StepTimer`` under a scripted fake clock (phases, an unannotated
  stretch, ``phase_scope``/``note`` inside and between steps, a detach):
  the totals, the gauges (``perf_goodput``, ``perf_mfu``,
  ``perf_last_step_seconds``), the step counter and every histogram's
  count and sum equal JAX's exactly (the same float arithmetic in the same
  order);
- ``phase_scope``/``note`` route to the active timer, a between-step
  ``data_wait`` lowers goodput, ``obs.reset()`` detaches a timer;
- the peak table: the JAX entries, the H100 spellings, CPU detection;
- ``window_stats`` equal to JAX's on the same snapshots;
- the tiny Llama's ``compile_train_step`` flops equal the analytic count
  of its products (6 N T for the matmul parameters, 14 B H D pairs per
  layer of attention, 2 T h V of the fused loss's recompute) within 1%
  (the elementwise kernels' few operations an element are the rest);
  JAX's ``cost_analysis`` of its own train step is printed beside it;
- the port's engine registers the JAX engine's program labels for the
  same workload, each with flops and HBM bytes;
- 10 tiny steps under ``StepTimer(program=step.program)``, then
  ``obs.dump_run(p)``: ``tools/obs_report.py p --check`` exits 0 and
  renders ``[perf]``; with the ``xla_program_flops`` gauges stripped it
  exits 4 (``tests/test_perf_introspection.py:590`` for JAX).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.observability as jobs
from paddle_tpu import jit as jjit
from paddle_tpu import optimizer as jopt
from paddle_tpu.inference.engine import GenerationEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability import perf as jperf
from paddle_tpu.observability import xla_introspect as jxi

import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.inference import GenerationEngine
from paddle_tpu_torch.jit import compile_train_step
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import perf as tperf
from paddle_tpu_torch.observability import xla_introspect as txi
from paddle_tpu_torch.ops.kernels import _cost

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _script(perf):
    """One scripted run: 3 steps with every phase, an unannotated
    stretch, phase_scope and note inside a step, a between-step loader
    stall and checkpoint, then a detach. Returns (timer, totals)."""
    clk = FakeClock()
    t = perf.StepTimer(flops_per_step=3e9, peak=1e12, clock=clk)
    for i in range(3):
        with t.step():
            with t.phase("data_wait"):
                clk.advance(0.05 * (i + 1))
            with t.phase("dispatch"):
                clk.advance(0.125)
            with t.phase("compute"):
                clk.advance(0.375 + 0.1 * i)
            with perf.phase_scope("optimizer"):
                clk.advance(0.0625)
            perf.note("checkpoint", 0.02)
            clk.advance(0.2)                  # unannotated -> other
        perf.note("data_wait", 0.3)           # between-step stall
        with perf.phase_scope("checkpoint"):
            clk.advance(0.5)
    t.detach()
    perf.note("data_wait", 9.0)               # detached: dropped
    return t, t.totals()


def _ledger(obs):
    snap = obs.REGISTRY.snapshot()
    keep = ("perf_", "step_phase_seconds", "step_wall_seconds")
    out = {}
    for kind in ("counters", "gauges"):
        out[kind] = {k: v for k, v in snap[kind].items()
                     if k.startswith(keep)}
    out["histograms"] = {k: (v["count"], v["sum"])
                         for k, v in snap["histograms"].items()
                         if k.startswith(keep)}
    return out


def test_steptimer_script_equals_jax_exactly():
    jobs.reset()
    tobs.reset()
    _, jt = _script(jperf)
    _, tt = _script(tperf)
    assert tt == jt
    assert tt["steps"] == 3 and set(tt["phases"]) == {
        "data_wait", "dispatch", "compute", "optimizer", "checkpoint",
        "other"}
    jl, tl = _ledger(jobs), _ledger(tobs)
    assert tl == jl
    assert tl["gauges"]["perf_goodput"] > 0
    assert tl["gauges"]["perf_mfu"] > 0
    assert tl["counters"]["perf_steps_total"] == 3
    # phase histogram sums reconstruct the wall histogram's sum
    phases = sum(s for k, (_, s) in tl["histograms"].items()
                 if k.startswith("step_phase_seconds"))
    assert phases == pytest.approx(tl["histograms"]["step_wall_seconds"][1])


def test_phase_scope_and_note_route_to_active_timer():
    clk = FakeClock()
    t = tperf.StepTimer(clock=clk)
    with t.step():
        with tperf.phase_scope("checkpoint"):
            clk.advance(0.3)
        tperf.note("data_wait", 0.25)
        clk.advance(0.45)
    tot = t.totals()
    assert tot["phases"]["checkpoint"] == pytest.approx(0.3)
    assert tot["phases"]["data_wait"] == pytest.approx(0.25)
    tperf.note("data_wait", 1.0)            # between steps: still attached
    tot = t.totals()
    assert tot["phases"]["data_wait"] == pytest.approx(1.25)
    assert tot["wall"] == pytest.approx(0.75 + 1.0)
    t.detach()
    with tperf.phase_scope("checkpoint"):
        pass
    tperf.note("data_wait", 1.0)
    assert t.totals()["phases"]["data_wait"] == pytest.approx(1.25)
    assert tperf.current_timer() is None


def test_between_step_data_wait_lowers_goodput_and_reset_detaches():
    tobs.reset()
    clk = FakeClock()
    t = tperf.StepTimer(clock=clk)
    for _ in range(2):
        with t.step():
            with t.phase("compute"):
                clk.advance(0.1)
        tperf.note("data_wait", 0.9)
    assert t.totals()["goodput"] == pytest.approx(0.1)
    assert tobs.REGISTRY.get("perf_goodput").value == pytest.approx(0.1)
    assert tperf.current_timer() is t
    tobs.reset()
    assert tperf.current_timer() is None


def test_peak_table():
    for k, v in jperf.PEAK_FLOPS.items():       # the JAX entries, kept
        assert tperf.PEAK_FLOPS[k] == v
    for name in ("v5e", "TPU v5 lite", "v5p", "v6e", "v4", "cpu",
                 "unknown-device"):
        assert tperf.peak_flops(name) == jperf.peak_flops(name)
    assert tperf.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tperf.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert tperf.peak_flops("h100") == 989e12
    if not torch.cuda.is_available():
        assert tperf.peak_flops() == 1e12


def test_window_stats_equal_jax():
    clk = FakeClock()
    t = tperf.StepTimer(flops_per_step=1e9, peak=1e12, clock=clk)
    with t.step():
        with t.phase("compute"):
            clk.advance(1.0)
    before = t.totals()
    with t.step():
        with t.phase("compute"):
            clk.advance(0.5)
        with t.phase("dispatch"):
            clk.advance(0.25)
    after = t.totals()
    t.detach()
    got = tperf.window_stats(before, after, flops_per_step=1e9, peak=1e12)
    want = jperf.window_stats(before, after, flops_per_step=1e9, peak=1e12)
    assert got == want
    assert got["mfu"] == pytest.approx(1e9 / 0.75 / 1e12)


# ----------------------------------------------------------------------
# program introspection
# ----------------------------------------------------------------------

BATCH, SEQ = 2, 16


def _tiny_pair():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny())
    arrays = {n: np.asarray(p._value, np.float32)
              for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    weights.from_paddle_tpu_state(arrays, tm)
    return jm, tm


def _analytic_train_flops(cfg, model):
    t = BATCH * SEQ
    n = sum(p.numel() for p in model.parameters()) - \
        model.llama.embed_tokens.weight.numel()
    hd = cfg.hidden_size // cfg.num_attention_heads
    attn = 14 * BATCH * cfg.num_attention_heads * hd * \
        _cost.causal_pairs(SEQ, SEQ) * cfg.num_hidden_layers
    return 6 * n * t + attn + 2 * t * cfg.hidden_size * cfg.vocab_size


def test_train_step_flops_equal_the_analytic_count():
    jm, tm = _tiny_pair()
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 128, (BATCH, SEQ)).astype(np.int64)
    loss_fn = lambda m, i, l: m(i, labels=l)  # noqa: E731
    step = compile_train_step(tm, loss_fn,
                              topt.AdamW(1e-3, parameters=tm.parameters()))
    assert not txi.registered(step.program)
    step(torch.from_numpy(ids), torch.from_numpy(ids))
    entry = txi.programs()[step.program]
    counted = entry["flops"]
    want = _analytic_train_flops(tm.config, tm)
    assert counted == pytest.approx(want, rel=0.01)
    # every hand-written kernel of the step is charged from its shapes
    assert set(entry["kernels"]) == {
        "rms_norm", "swiglu", "fused_rope", "fused_rope_bwd",
        "flash_attention", "flash_attention_bwd"}
    assert entry["kernels"]["flash_attention"]["calls"] == \
        tm.config.num_hidden_layers
    g = tobs.REGISTRY.get("xla_program_flops",
                          labels={"program": step.program})
    assert g is not None and g.value == counted
    total = tobs.REGISTRY.get("xla_hbm_bytes", labels={
        "program": step.program, "kind": "total"})
    assert total is not None and total.value > 0
    # a later step is not counted again
    step(torch.from_numpy(ids), torch.from_numpy(ids))
    assert txi.programs()[step.program]["flops"] == counted
    # JAX's cost_analysis of its own train step, printed beside the count
    jstep = jjit.compile_train_step(
        jm, loss_fn, jopt.AdamW(1e-3, parameters=jm.parameters()))
    jstep(paddle.to_tensor(ids.astype(np.int32)),
          paddle.to_tensor(ids.astype(np.int32)))
    jname = [n for n in jxi.programs() if n.startswith("train_step")][-1]
    jflops = jxi.flops_of(jname)
    print(f"train_step flops: port counted {counted:.6e}, analytic "
          f"{want:.6e} (ratio {counted / want:.4f}), JAX cost_analysis "
          f"{jflops:.6e} (JAX / port {jflops / counted:.3f})")


def test_train_step_registers_after_telemetry_reenabled():
    model = torch.nn.Linear(4, 4)
    step = compile_train_step(
        model, lambda m, x, y: ((m(x) - y) ** 2).mean(),
        topt.SGD(0.1, parameters=model.parameters()))
    x, y = torch.ones(2, 4), torch.zeros(2, 4)
    with tobs.disabled_scope():
        step(x, y)
    assert not txi.registered(step.program)
    step(x, y)
    # the forward product and the weight's gradient (x takes none)
    assert txi.programs()[step.program]["flops"] == 2 * (2 * 4 * 4) * 2


ENGINE_KW = dict(max_slots=2, page_size=4, max_seq_len=64,
                 prefix_cache=True, prefill_chunk=8, mixed_step=True)


def test_engine_registers_the_jax_program_labels():
    jm, tm = _tiny_pair()
    rng = np.random.default_rng(1)
    shared = rng.integers(1, 128, 12)
    prompts = [np.concatenate([shared, rng.integers(1, 128, 5)]),
               rng.integers(1, 128, 3), rng.integers(1, 128, 14),
               np.concatenate([shared, rng.integers(1, 128, 3)])]
    jxi.reset()
    txi.reset()

    def wave(eng, **kw):
        for p in prompts:
            eng.add_request(np.asarray(p), max_new_tokens=6, **kw)
        eng.run()

    for make in (lambda: JaxEngine(jm, **ENGINE_KW),
                 lambda: GenerationEngine(tm, **ENGINE_KW)):
        eng = make()
        wave(eng)
        wave(eng, temperature=1.5)
    # mixed_step as the TPU runs it (the JAX default off the TPU is False)
    dense = dict(max_slots=2, page_size=4, max_seq_len=64, mixed_step=True)
    for make in (lambda: JaxEngine(jm, **dense),
                 lambda: GenerationEngine(tm, **dense)):
        wave(make())
    jl = {n for n in jxi.programs() if n.startswith("engine:")}
    tl = set(txi.programs())
    assert tl == jl, (sorted(tl - jl), sorted(jl - tl))
    kinds = {n.split(":")[1] for n in tl}
    assert {"decode", "prefill", "ragged"} <= kinds
    assert any(n.endswith(":sample") for n in tl)
    for n, e in txi.programs().items():
        assert e["flops"] and e["flops"] > 0, n
        assert e["hbm_total"] and e["hbm_total"] > 0, n
        assert tobs.REGISTRY.get("xla_program_bytes_accessed",
                                 labels={"program": n}).value > 0


def test_ten_steps_dump_and_obs_report_check(tmp_path):
    tobs.reset()
    torch.manual_seed(0)
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    weights.init_random_(tm, seed=0)
    step = compile_train_step(tm, lambda m, i, l: m(i, labels=l),
                              topt.AdamW(1e-3, parameters=tm.parameters()))
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (BATCH, SEQ)))
    step(ids, ids)                          # counted, outside the window
    timer = tperf.StepTimer(program=step.program, platform="cpu")
    assert timer.resolve_flops() == txi.flops_of(step.program) > 0
    for _ in range(10):
        with timer.step():
            with timer.phase("dispatch"):
                loss = step(ids, ids)
            with timer.phase("compute"):
                float(loss)
    timer.detach()
    assert timer.totals()["steps"] == 10
    assert tobs.REGISTRY.get("perf_mfu").value > 0
    assert 0 < tobs.REGISTRY.get("perf_goodput").value <= 1.0
    prefix = str(tmp_path / "run")
    paths = tobs.dump_run(prefix)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(ROOT / "tools/obs_report.py"),
                          prefix, "--check"], capture_output=True,
                         text=True, env=env, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[perf]" in res.stdout
    assert step.program in res.stdout
    with open(paths[0]) as f:
        metrics = json.load(f)
    metrics["gauges"] = {k: v for k, v in metrics["gauges"].items()
                         if not k.startswith("xla_program_flops")}
    with open(paths[0], "w") as f:
        json.dump(metrics, f)
    res = subprocess.run([sys.executable, str(ROOT / "tools/obs_report.py"),
                          prefix, "--check"], capture_output=True,
                         text=True, env=env, timeout=120, cwd=ROOT)
    assert res.returncode == 4, res.stdout + res.stderr


def test_hbm_ledger_and_registration_api_equal_jax(monkeypatch):
    """record_analysis's gauges, watermark and once-only over-budget event
    equal JAX's for the same script; register_call counts a live call
    once; register_thunk waits for harvest (or flops_of); the budget
    comes from the override, then PADDLE_TPU_HBM_BUDGET_GB."""
    events = {}
    for name, xi, obs in (("jax", jxi, jobs), ("port", txi, tobs)):
        obs.reset()
        xi.set_hbm_budget(1000)
        try:
            for prog, mem in (("prog_small", (100, 50, 200, 10)),
                              ("prog_big", (600, 100, 700, 0)),
                              ("prog_big", (600, 100, 700, 0))):
                xi.record_analysis(prog, flops=1.0, bytes_accessed=7.0,
                                   mem=dict(zip(("args", "outputs", "temps",
                                                 "code"), mem), alias=0))
            events[name] = (
                [{k: e[k] for k in ("program", "hbm_bytes", "budget_bytes",
                                    "over")}
                 for e in obs.EVENTS.events("hbm_over_budget")],
                xi.hbm_high_watermark_bytes(),
                _ledger_of(obs))
        finally:
            xi.set_hbm_budget(None)
    assert events["port"] == events["jax"]
    assert events["port"][1] == 1400 and len(events["port"][0]) == 1

    txi.reset()
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    out = txi.register_call("t_mm", torch.matmul, a, b)
    assert torch.equal(out, a @ b)
    assert txi.flops_of("t_mm") == 2 * 8 * 16 * 4
    for kind, want in (("args", (a.numel() + b.numel()) * 4),
                       ("outputs", out.numel() * 4)):
        assert tobs.REGISTRY.get("xla_hbm_bytes", labels={
            "program": "t_mm", "kind": kind}).value == want
    txi.register_call("t_mm", torch.matmul, b.t(), a.t())   # not recounted
    assert txi.flops_of("t_mm") == 2 * 8 * 16 * 4
    assert txi.register_thunk("t_th", lambda: {"flops": 5.0})
    assert not txi.register_thunk("t_th", lambda: {"flops": 6.0})
    assert txi.pending_count() == 1
    assert txi.flops_of("t_th", harvest_missing=False) is None
    assert txi.harvest() == ["t_th"] and txi.flops_of("t_th") == 5.0
    assert txi.pending_count() == 0 and txi.program_count() == 2
    monkeypatch.setenv("PADDLE_TPU_HBM_BUDGET_GB", "2")
    assert txi.hbm_budget_bytes() == 2 * 1024 ** 3


def _ledger_of(obs):
    """The xla_ gauges of the scripted programs and the watermark."""
    snap = obs.REGISTRY.snapshot()
    return {k: v for k, v in snap["gauges"].items() if k.startswith("xla_")
            and ("prog_" in k or k == "xla_hbm_high_watermark_bytes")}
