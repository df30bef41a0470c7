"""The port's observability modules and the engine series they carry,
against the JAX package's.

- the same workload through the JAX engine and the port's engine (a tiny
  Llama, float32 weights bridged from the JAX model): dense admissions,
  chunked prefill, prefix hits, a fork with its copy-on-write, recompute
  preemption in an oversubscribed pool, a cancel, KV export and import,
  spill and refill through a PrefixStore, and n-gram speculative
  decoding. Each package's registry then holds the same ``engine_*`` and
  ``spec_*`` series names (the tensor-parallel engine's two aside: they
  appear when another test of the process built a mesh engine), and
  every counter and histogram count
  moved by the same amount in both (wall-clock sums aside);
- the registry, the event ring, the Prometheus text and the tracing
  sketches of the port behave as the JAX package's on the same calls, and
  the two packages hold separate registries.

The workload runs in a fresh process (this file run as a script), so no
other test's engine or thread in the same worker moves a counter of
either registry meanwhile.

Tolerance: exact equality of names, counter deltas and histogram counts.
"""

import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import GenerationEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability import exporters as jexp
from paddle_tpu.observability import tracing as jtr
from paddle_tpu.observability.metrics import REGISTRY as JREG
from paddle_tpu.serving import PrefixStore as JaxPrefixStore

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import weights
from paddle_tpu_torch.inference import GenerationEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import exporters as texp
from paddle_tpu_torch.observability import tracing as ttr
from paddle_tpu_torch.observability.metrics import REGISTRY as TREG
from paddle_tpu_torch.serving import PrefixStore

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(vocab=128, hidden=32, layers=2, heads=4, kv_heads=2, ffn=64,
           seq=128)
KW = dict(max_slots=2, page_size=8, max_seq_len=128, prefill_chunk=16,
          mixed_step=False)
PREFIXES = ("engine_", "spec_")
# wall-clock series: their values are times, not counts
TIMED = ("engine_busy_seconds_total",)
# series only the tensor-parallel engine registers (serving/
# mesh_engine.py; not built by this workload): present in the JAX
# registry when another test of the process built a mesh engine
MESH_ONLY = {"engine_mesh_devices", "engine_kv_pool_shard_bytes"}


def _pair():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny(**CFG))
    jm.eval()
    arrays = {n: np.asarray(p._value, np.float32)
              for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    weights.from_paddle_tpu_state(arrays, tm)
    return jm, tm


def _ours(name):
    return name.startswith(PREFIXES) and not name.startswith(TIMED)


def _counts(reg):
    """{series key: value} of the engine counters and {key: count} of
    the engine histograms."""
    snap = reg.snapshot()
    out = {k: v for k, v in snap["counters"].items() if _ours(k)}
    out.update({f"{k}#count": h["count"]
                for k, h in snap["histograms"].items() if _ours(k)})
    return out


def _names(reg):
    snap = reg.snapshot()
    return {k.partition("{")[0] for kind in ("counters", "gauges",
                                             "histograms")
            for k in snap[kind] if k.startswith(PREFIXES)}


def _workload(make, store):
    """One scripted workload; `make(**kw)` builds an engine of the
    package under test, `store` is that package's PrefixStore."""
    rng = np.random.default_rng(11)
    shared = rng.integers(1, 127, 16)
    prompts = [np.concatenate([shared, rng.integers(1, 127, n)])
               for n in (5, 9, 30)] + [rng.integers(1, 127, 6)]

    eng = make()                         # dense, chunked, prefix hits
    rids = [eng.add_request(p, max_new_tokens=10) for p in prompts]
    eng.run()
    rid = eng.add_request(prompts[0], max_new_tokens=12)
    it = eng.stream_request(rid, 0)
    next(it), next(it)
    it.close()
    child = eng.fork_request(rid, max_new_tokens=6)   # CoW on first write
    assert child is not None
    eng.run()
    victim = eng.add_request(prompts[1], max_new_tokens=8)
    eng.cancel_request(victim)
    meta, payload = eng.export_kv_pages(prompts[2])   # KV out and in
    dst = make()
    assert dst.import_kv_pages(meta, payload) > 0
    r2 = dst.add_request(prompts[2], max_new_tokens=6)
    dst.run()
    assert r2 is not None and rids

    small = make(max_slots=2, n_pages=12, prefix_store=store)   # preempt,
    for p in prompts + [rng.integers(1, 127, 40) for _ in range(3)]:
        small.add_request(p, max_new_tokens=12)       # spill, refill
    small.run()
    small.add_request(prompts[2], max_new_tokens=4)
    small.run()

    spec = make(spec_decode="ngram")                  # drafts + fallbacks
    loop = np.tile(rng.integers(1, 127, 4), 6)
    for p in (loop, prompts[3]):
        spec.add_request(p, max_new_tokens=12)
    spec.run()


def _measure():
    """Both packages' counter deltas and series names after the same
    workload (this process's registries)."""
    jm, tm = _pair()
    j0, t0 = _counts(JREG), _counts(TREG)
    _workload(lambda **kw: JaxEngine(jm, **dict(KW, **kw)),
              JaxPrefixStore())
    _workload(lambda **kw: GenerationEngine(tm, **dict(KW, **kw)),
              PrefixStore())
    j1, t1 = _counts(JREG), _counts(TREG)
    return {"jax": {k: v - j0.get(k, 0) for k, v in j1.items()
                    if v != j0.get(k, 0)},
            "port": {k: v - t0.get(k, 0) for k, v in t1.items()
                     if v != t0.get(k, 0)},
            "jax_names": sorted(_names(JREG) - MESH_ONLY),
            "port_names": sorted(_names(TREG))}


def test_same_workload_same_series_and_counter_deltas():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    td, jd = res["port"], res["jax"]
    assert td == jd
    for name in ("engine_admissions_total", "engine_prefix_cache_hits_total",
                 "engine_cow_copies_total", "engine_preemptions_total",
                 "engine_cancelled_total", "engine_kv_pages_imported_total",
                 "engine_kv_pages_spilled_total",
                 "engine_kv_pages_refilled_total", "spec_draft_tokens_total",
                 "engine_ttft_seconds#count"):
        assert td.get(name, 0) > 0, name
    assert res["port_names"] == res["jax_names"]


def test_registry_instruments_under_threads():
    c = obs.counter("torch_test_threads_total", "t")
    g = obs.gauge("torch_test_gauge", "t")
    h = obs.histogram("torch_test_seconds", "t", buckets=(0.1, 1.0))
    c0 = c.value

    def work():
        for i in range(500):
            c.inc()
            h.observe(0.05 if i % 2 else 0.5)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    g.set(3)
    assert c.value - c0 == 2000 and g.value == 3
    assert obs.counter("torch_test_threads_total") is c
    with pytest.raises(TypeError):
        obs.gauge("torch_test_threads_total")


def test_port_registry_is_its_own():
    name = "torch_test_separate_total"
    obs.counter(name, "t").inc(5)
    assert name in TREG.snapshot()["counters"]
    assert name not in JREG.snapshot()["counters"]


def test_exports_and_sketches_match_jax():
    """Prometheus text, the event ring and the quantile sketches give the
    same results as the JAX package's on the same calls."""
    for reg, exp in ((JREG, jexp), (TREG, texp)):
        reg.counter("torch_test_prom_total", "p",
                    labels={"dir": "in"}).inc(3)
        reg.histogram("torch_test_prom_seconds", "p",
                      buckets=(0.5, 1.0)).observe(0.7)
    texts = [[ln for ln in exp.prometheus_text().splitlines()
              if "torch_test_prom" in ln] for exp in (jexp, texp)]
    assert texts[0] == texts[1] and texts[0]
    vals = np.random.default_rng(2).exponential(1.0, 3000).tolist()
    sk = [mod.QuantileSketch() for mod in (jtr, ttr)]
    for s in sk:
        for v in vals:
            s.add(v)
    assert [sk[0].quantile(q) for q in (0.5, 0.95, 0.99)] \
        == [sk[1].quantile(q) for q in (0.5, 0.95, 0.99)]
    assert ttr.sanitize_tenant("a b@c") == jtr.sanitize_tenant("a b@c")
    assert len(ttr.new_trace_id()) == 16


if __name__ == "__main__":
    print(json.dumps(_measure()))
