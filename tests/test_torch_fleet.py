"""The port's serving fleet (``paddle_tpu_torch.serving``) over its engine,
held to the JAX package.

A tiny Llama (float32 weights bridged from the JAX model; pages of 8) in
LocalReplicas behind one Router:

- greedy parity: the router's outputs equal one port engine's and the JAX
  engine's;
- a replica killed mid-stream under concurrent streams: zero failed
  requests, every stream complete and token-exact, no duplicate token;
- prefix-affinity placement sends sharers to the owner and falls back
  when it dies; least-load placement;
- shedding under ``admission_budget``: the accounting identity
  ``offered == completed + shed + failed + abandoned`` holds, nothing
  failed;
- the role split (prefill replica -> decode replica, KV handed off) and a
  drain with transfer: token-exact, the handoff and transfer counters
  move, no fallback to a re-prefill;
- a hot weight swap of a checkpoint that the JAX package committed: the
  port replica's tokens after the swap equal a JAX replica's serving the
  same weights; an uncommitted checkpoint is never swapped in;
- the supervisor replaces a killed replica and quarantines one whose
  heartbeats black out (``paddle_tpu.testing.faults``, from the test
  side only), then re-admits it;
- a ``ProcessReplica`` pair (``python -m paddle_tpu_torch.serving.worker``
  with ``"device": "cpu"``): one is SIGKILLed mid-stream, and every stream
  completes exactly once with an in-process engine's tokens.

Every wait has a timeout; nothing asserts on wall-clock gaps.
Tolerance: exact token equality.
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jdck
from paddle_tpu.inference.engine import GenerationEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import LocalReplica as JaxLocalReplica
from paddle_tpu.serving import Router as JaxRouter
from paddle_tpu.testing import faults

from paddle_tpu_torch import weights
from paddle_tpu_torch.inference import GenerationEngine
from paddle_tpu_torch.inference.engine import prefix_chain_hashes
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability.metrics import REGISTRY
from paddle_tpu_torch.serving import (HB_KEY_PREFIX, FileStore,
                                      LocalReplica, ProcessReplica,
                                      RequestShedError, Router, Supervisor,
                                      SupervisorPolicy)
from paddle_tpu_torch.serving.worker import build_model

torch.set_num_threads(1)

CFG = dict(vocab=128, hidden=32, layers=2, heads=4, kv_heads=2, ffn=64,
           seq=128)
KW = dict(max_slots=4, page_size=8, max_seq_len=128, prefill_chunk=16,
          mixed_step=False)
PAGE = KW["page_size"]

_RNG = np.random.default_rng(42)
PROMPTS = [_RNG.integers(1, 127, (n,)).astype(np.int32)
           for n in (16, 20, 27, 33)]


def _counter(name):
    return REGISTRY.counter(name).value


def _jax_model(seed=0):
    paddle.seed(seed)
    m = JaxLlama(JaxLlamaConfig.tiny(**CFG))
    m.eval()
    return m


def _arrays(jm):
    return {n: np.asarray(p._value, np.float32)
            for n, p in jm.named_parameters()}


@pytest.fixture(scope="module")
def state():
    return _arrays(_jax_model(0))


def _model(state):
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    return weights.from_paddle_tpu_state(state, tm)


def _local(state, name, role=None, **kw):
    m = _model(state)
    return LocalReplica(name, m, engine=GenerationEngine(m, **KW), role=role,
                        **kw)


@pytest.fixture(scope="module")
def refs():
    """The JAX engine's 24 greedy tokens for each prompt."""
    eng = JaxEngine(_jax_model(0), **KW)
    rids = [eng.add_request(p, max_new_tokens=24) for p in PROMPTS]
    out = eng.run()
    return [[int(t) for t in out[r][len(p):]] for r, p in zip(rids, PROMPTS)]


def _stream_all(router, prompts, n_new, on_token=None):
    """Stream every prompt from its own thread; returns (results, errors)."""
    results, errors = [None] * len(prompts), []

    def client(i):
        try:
            toks = []
            for t in router.stream(prompts[i], max_new_tokens=n_new):
                toks.append(t)
                if on_token is not None:
                    on_token()
            results[i] = toks
        except Exception as e:  # noqa: BLE001 — the test grades this
            errors.append(f"{i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    return threads, results, errors


def _join(threads, timeout=120):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


def test_router_greedy_parity_with_one_engine(state, refs):
    eng = GenerationEngine(_model(state), **KW)
    rids = [eng.add_request(p, max_new_tokens=24) for p in PROMPTS]
    out = eng.run()
    assert [[int(t) for t in out[r][len(p):]]
            for r, p in zip(rids, PROMPTS)] == refs
    router = Router({n: _local(state, n) for n in ("r0", "r1")},
                    page_size=PAGE)
    threads, results, errors = _stream_all(router, PROMPTS, 24)
    _join(threads)
    assert not errors and results == refs
    router.stop()


def test_kill_mid_stream_zero_failed_exactly_once(state, refs):
    reps = {n: _local(state, n) for n in ("r0", "r1")}
    router = Router(reps, page_size=PAGE)
    f0 = _counter("fleet_requests_failed_total")
    d0 = _counter("fleet_dup_tokens_suppressed_total")
    rr0 = _counter("fleet_requests_rerouted_total")
    delivered, mid = [0], threading.Event()

    def on_token():
        delivered[0] += 1
        if delivered[0] >= 4:
            mid.set()

    # the replicas crawl, so the kill lands while every stream is live
    with faults.BrownoutInjector(reps["r0"], 0.01), \
            faults.BrownoutInjector(reps["r1"], 0.01):
        threads, results, errors = _stream_all(router, PROMPTS, 24,
                                               on_token)
        assert mid.wait(120)
        reps["r0"].kill()
        _join(threads)
    assert not errors and results == refs
    assert _counter("fleet_requests_failed_total") == f0
    assert _counter("fleet_dup_tokens_suppressed_total") == d0
    assert _counter("fleet_requests_rerouted_total") > rr0
    router.stop()


def test_prefix_affinity_routes_sharers_to_owner(state):
    reps = {n: _local(state, n) for n in ("r0", "r1")}
    router = Router(reps, page_size=PAGE)
    shared = np.random.default_rng(5).integers(1, 127, (32,)).astype(
        np.int32)
    assert len(prefix_chain_hashes(shared, PAGE)) == 4
    first, _ = router.place(shared)
    a0 = _counter("fleet_prefix_affinity_hits_total")
    sharer = np.concatenate([shared, [3, 4, 5, 6]]).astype(np.int32)
    chosen, _ = router.place(sharer)
    assert chosen == first
    assert _counter("fleet_prefix_affinity_hits_total") == a0 + 1
    reps[first].kill()                  # the owner dies: least-load
    chosen2, _ = router.place(sharer)
    assert chosen2 == ("r1" if first == "r0" else "r0")
    router.stop()


def test_least_load_placement_spreads_queue(state):
    router = Router({n: _local(state, n) for n in ("r0", "r1")},
                    page_size=PAGE)
    router._inflight["r0"] = 3
    assert router.place(PROMPTS[0])[0] == "r1"
    router.stop()


def test_shedding_keeps_the_accounting_identity(state, refs):
    reps = {n: _local(state, n) for n in ("r0", "r1")}
    router = Router(reps, page_size=PAGE, admission_budget=2)
    acc0 = router.fleet_accounting()
    prompts = PROMPTS * 2
    done, shed, lock = [], [0], threading.Lock()

    def drive(i):
        try:
            toks = list(router.stream(prompts[i], max_new_tokens=24,
                                      tenant=f"t{i % 2}"))
            with lock:
                done.append((i, toks))
        except RequestShedError as e:
            assert e.reason == "capacity" and e.budget == 2
            with lock:
                shed[0] += 1

    with faults.BrownoutInjector(reps["r0"], 0.01), \
            faults.BrownoutInjector(reps["r1"], 0.01):
        threads = [threading.Thread(target=drive, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        _join(threads)
    acc1 = router.fleet_accounting()
    acc = {k: acc1[k] - acc0[k] for k in acc0}
    assert shed[0] > 0 and acc["shed"] == shed[0]
    assert acc["offered"] == len(prompts)
    assert acc["offered"] == acc["completed"] + acc["shed"] + \
        acc["failed"] + acc["abandoned"]
    assert acc["failed"] == 0 and Router.accounting_identity_ok(acc)
    assert all(toks == refs[i % len(PROMPTS)] for i, toks in done)
    router.stop()


def test_role_split_handoff_token_exact(state, refs):
    h0 = _counter("fleet_prefill_handoffs_total")
    p0 = _counter("fleet_kv_transfer_pages_total")
    fb0 = _counter("fleet_kv_transfer_fallbacks_total")
    imp0 = _counter("engine_kv_pages_imported_total")
    reps = {"p0": _local(state, "p0", "prefill"),
            "d0": _local(state, "d0", "decode")}
    router = Router(reps, page_size=PAGE)
    outs = [router.generate(p, max_new_tokens=24) for p in PROMPTS]
    assert outs == refs
    assert _counter("fleet_prefill_handoffs_total") - h0 == len(PROMPTS)
    assert _counter("fleet_kv_transfer_pages_total") - p0 \
        == sum(len(p) // PAGE for p in PROMPTS)
    assert _counter("fleet_kv_transfer_fallbacks_total") == fb0
    assert _counter("engine_kv_pages_imported_total") > imp0
    assert reps["d0"].engine.upload_trace_count > 0
    router.stop()


def test_drain_with_transfer_moves_every_stream(state, refs):
    reps = {n: _local(state, n) for n in ("r0", "r1")}
    router = Router(reps, page_size=PAGE)
    d0 = _counter("fleet_drain_exports_total")
    t0 = _counter("fleet_kv_transfer_pages_total")
    fb0 = _counter("fleet_kv_transfer_fallbacks_total")
    f0 = _counter("fleet_requests_failed_total")
    delivered, fired = [0], []

    def on_token():
        delivered[0] += 1
        if delivered[0] >= 6 and not fired:
            fired.append(1)         # from inside a consumer: mid-decode
            router.drain("r0")

    with faults.BrownoutInjector(reps["r0"], 0.01), \
            faults.BrownoutInjector(reps["r1"], 0.01):
        threads, results, errors = _stream_all(router, PROMPTS, 24,
                                               on_token)
        _join(threads)
    assert not errors and results == refs
    assert router.inflight_of("r0") == 0
    assert _counter("fleet_drain_exports_total") > d0
    assert _counter("fleet_kv_transfer_pages_total") > t0
    assert _counter("fleet_kv_transfer_fallbacks_total") == fb0
    assert _counter("fleet_requests_failed_total") == f0
    reps["r0"].kill()                   # nothing left to lose
    assert router.generate(PROMPTS[0], max_new_tokens=24) == refs[0]
    router.stop()


def _commit_jax(jm, root, step):
    from paddle_tpu.core.tensor import Tensor
    sd = {f"model::{k}": t for k, t in jm.state_dict().items()
          if isinstance(t, Tensor)}
    jdck.save_checkpoint(sd, root, step)


def _wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def test_hot_swap_of_a_jax_committed_checkpoint(state, tmp_path):
    """The port replica swaps in a checkpoint the JAX package committed,
    mid-stream, drops nothing, and then serves a JAX replica's tokens for
    the new weights; an uncommitted step is never swapped in."""
    root = str(tmp_path / "ckpt")
    rep = _local(state, "r0", ckpt_root=root, weight_poll_interval=0.01)
    router = Router({"r0": rep}, page_size=PAGE)
    trained = _jax_model(123)
    # a step directory without LATEST (a crash before the commit)
    from paddle_tpu.core.tensor import Tensor
    jdck.save_state_dict({f"model::{k}": t for k, t in
                          trained.state_dict().items()
                          if isinstance(t, Tensor)},
                         jdck.checkpoint_dir(root, 5))
    time.sleep(0.02)
    rep.poll()
    assert rep.watcher.swaps == 0 and rep.watcher.loaded_step == -1

    toks = []
    for i, t in enumerate(router.stream(PROMPTS[1], max_new_tokens=24)):
        toks.append(t)
        if i == 2:
            _commit_jax(trained, root, 7)
            time.sleep(0.02)            # > weight_poll_interval
    assert len(toks) == 24
    _wait_for(lambda: rep.poll() or rep.watcher.loaded_step == 7)
    assert rep.watcher.swaps == 1
    assert not rep.engine.blocks._index     # old-epoch KV never indexed
    got = [router.generate(p, max_new_tokens=16) for p in PROMPTS[:2]]
    jrep = JaxLocalReplica("j0", trained,
                           engine=JaxEngine(trained, **KW))
    jrouter = JaxRouter({"j0": jrep}, page_size=PAGE)
    want = [jrouter.generate(p, max_new_tokens=16) for p in PROMPTS[:2]]
    assert got == want
    tm = rep.model
    for name, arr in _arrays(trained).items():
        np.testing.assert_array_equal(
            dict(tm.named_parameters())[name].detach().numpy(), arr)
    router.stop()
    jrouter.stop()


def test_supervisor_replaces_dead_and_quarantines_blacked_out(state, refs,
                                                              tmp_path):
    store = FileStore(str(tmp_path / "store"))
    reps = {n: _local(state, n, store=store, heartbeat_interval=0.02)
            for n in ("r0", "r1")}
    router = Router(reps, store=store, page_size=PAGE,
                    heartbeat_timeout=0.3)
    spawned = []

    def spawn(name):
        spawned.append(name)
        return _local(state, name, store=store, heartbeat_interval=0.02)

    policy = SupervisorPolicy(target_replicas=2, quarantine_streak=1,
                              scale_up_streak=100, scale_down_streak=100,
                              backoff_base=0.0, backoff_cap=0.0,
                              backoff_jitter=0.0, backoff_seed=0)
    sup = Supervisor(router, spawn_fn=spawn, policy=policy)
    _wait_for(lambda: router.check_heartbeats() == ["r0", "r1"])
    sup.tick()                          # baseline window: clean
    assert not sup.decisions_log

    reps["r0"].kill()                   # replace
    _wait_for(lambda: (sup.tick() or True) and spawned == ["r0"])
    actions = [(a, r) for _, a, _, r in sup.decisions_log]
    assert ("replace", "replica_death") in actions
    assert router.generate(PROMPTS[0], max_new_tokens=24) == refs[0]

    # quarantine: r1's heartbeats black out (a healthy but mute replica)
    with faults.HeartbeatBlackout(store, duration=5.0,
                                  key=HB_KEY_PREFIX + "r1"):
        _wait_for(lambda: "r1" not in router.check_heartbeats())
        _wait_for(lambda: (sup.tick() or True)
                  and "r1" in sup.report()["quarantined"])
    assert "r1" in router.draining_replicas()
    _wait_for(lambda: "r1" in router.check_heartbeats())
    _wait_for(lambda: (sup.tick() or True)
              and sup.report()["quarantined"] == [])
    assert "r1" not in router.draining_replicas()
    assert router.generate(PROMPTS[1], max_new_tokens=24) == refs[1]
    router.stop()
    for h in router.registered_replicas().values():
        h.shutdown()


def test_process_replica_sigkill_drill():
    """Two subprocess workers on the CPU; one SIGKILLed mid-stream: zero
    failed requests, exactly-once delivery, tokens equal to an in-process
    engine over the same spec."""
    spec = {"kind": "llama_tiny", "seed": 3, "config": CFG,
            "engine": dict(KW), "device": "cpu"}
    eng = GenerationEngine(build_model(spec), **KW)
    rids = [eng.add_request(p, max_new_tokens=24) for p in PROMPTS]
    out = eng.run()
    want = [[int(t) for t in out[r][len(p):]] for r, p in zip(rids, PROMPTS)]
    env = {"OMP_NUM_THREADS": "1"}
    reps = {}
    try:
        for n in ("w0", "w1"):
            reps[n] = ProcessReplica(n, spec, startup_timeout=120.0,
                                     read_timeout=60.0, env=env)
        router = Router(reps, page_size=PAGE)
        f0 = _counter("fleet_requests_failed_total")
        d0 = _counter("fleet_dup_tokens_suppressed_total")
        delivered, mid = [0], threading.Event()

        def on_token():
            delivered[0] += 1
            if delivered[0] >= 4:
                mid.set()

        threads, results, errors = _stream_all(router, PROMPTS, 24,
                                               on_token)
        assert mid.wait(120)
        reps["w0"].kill()               # a real SIGKILL
        _join(threads)
        assert not reps["w0"].alive()
        assert not errors and results == want
        assert _counter("fleet_requests_failed_total") == f0
        assert _counter("fleet_dup_tokens_suppressed_total") == d0
        router.stop()
    finally:
        for r in reps.values():
            r.shutdown()
