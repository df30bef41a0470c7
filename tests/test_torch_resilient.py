"""The port's resilient training loop (``paddle_tpu_torch/distributed/
resilient.py``), comm watchdog (``watchdog.py``) and elastic manager
(``fleet/elastic``) against the JAX package's.

The tiny float32 Llama with the JAX weights bridged trains under
``ResilientTrainer`` in both packages, each step the eager loop
``loss = model(ids, labels=lab) * z; loss.backward(); opt.step();
opt.clear_grad()`` with AdamW (the JAX package's compiled train step
keeps its optimizer state apart from the optimizer until it is synced,
so its trainer drives the eager loop; on the port the eager loop is
``compile_train_step`` bit for bit). ``z`` is 1.0, or NaN where a case
poisons a step: the NaN reaches the gradients and, with no scaler, the
parameters, as a real divergence does. Under the same injected faults
(a NaN loss, N consecutive bad steps, a ``CommTimeoutError`` from
``watched_wait`` through its wait seam, an exhausted restart budget,
recovery before the first checkpoint) each case holds:

- the same sequence of event kinds, with the same steps in them;
- the same ``resilient_*`` counters and the same return (or raise);
- the losses of every step call within ``tests/test_torch_train.py``'s
  atol 1e-4 (NaN where both are NaN).

Within the port: a rollback and a restore copy back into the live
tensors (the same storage) bit for bit; the watchdog's timeout leaves no
crashing thread when the wedged wait fails late, dumps the flight ring
and mirrors a ``comm_timeout`` event; ``ElasticManager`` and the
trainer's re-rendezvous and peer watch behave as JAX's with a store and
two ranks.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.observability as jobs
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import resilient as jres
from paddle_tpu.distributed import watchdog as jwd
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama

import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.distributed import resilient as tres
from paddle_tpu_torch.distributed import watchdog as twd
from paddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                        ElasticStatus)
from paddle_tpu_torch.framework import set_flags
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import flight_recorder as tfr

torch.set_num_threads(1)

LR, BATCH, SEQ = 1e-3, 2, 8
LOSS_ATOL = 1e-4
# the event fields that name steps: they must agree exactly
STEP_KEYS = ("step", "to_step", "next_step", "resume_step", "ckpt_step",
             "consecutive", "attempt", "restart_budget_remaining",
             "rollbacks", "after_good_steps")


@pytest.fixture(scope="module")
def arrays():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny())
    return {n: np.asarray(p._value, np.float32)
            for n, p in jm.named_parameters()}


def _batches(n):
    rng = np.random.default_rng(5)
    return [(rng.integers(0, 128, (BATCH, SEQ)).astype(np.int32),
             rng.integers(0, 128, (BATCH, SEQ)).astype(np.int32))
            for _ in range(n)]


class _Side:
    """One package's model, optimizer, step and trainer module."""

    def __init__(self, name, arrays):
        self.name = name
        if name == "jax":
            paddle.seed(0)
            self.model = JaxLlama(JaxLlamaConfig.tiny())
            for n, p in self.model.named_parameters():
                p.set_value(arrays[n])
            self.opt = jopt.AdamW(LR, parameters=self.model.parameters())
            self.res, self.obs = jres, jobs
            self.wrap = paddle.to_tensor
        else:
            self.model = weights.from_paddle_tpu_state(
                arrays, LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"))
            self.opt = topt.AdamW(LR, parameters=self.model.parameters())
            self.res, self.obs = tres, tobs
            self.wrap = torch.from_numpy

    def step(self, ids, lab, z):
        i, l = self.wrap(ids), self.wrap(lab)
        zt = self.wrap(np.asarray(z, np.float32))
        loss = self.model(i, labels=l) * zt
        loss.backward()
        self.opt.step()
        self.opt.clear_grad()
        return loss

    def wait(self, loss, hang):
        """watched_wait on the loss; `hang` makes the wait seam sleep past
        the timeout (JAX: jax.block_until_ready; the port: _block)."""
        wd = jwd if self.name == "jax" else twd
        if hang:
            if self.name == "jax":
                orig = wd.jax.block_until_ready
                wd.jax.block_until_ready = lambda v: time.sleep(0.3)
            else:
                orig = wd._block
                wd._block = lambda v: time.sleep(0.3)
            try:
                wd.watched_wait(loss, timeout=0.02, what="train_step")
            finally:
                if self.name == "jax":
                    wd.jax.block_until_ready = orig
                else:
                    wd._block = orig
        else:
            wd.watched_wait(loss._value if self.name == "jax" else loss,
                            timeout=5.0, what="train_step")


def _loss_float(loss):
    return float(loss.numpy()) if hasattr(loss, "_value") else \
        float(loss.detach())


def _drive(side, root, total, nan_calls=(), hang_calls=(), fault_steps=(),
           **kw):
    """Run the trainer; the Nth step call (0-based, over the whole run,
    replays included) is poisoned when N is in nan_calls and hangs in
    watched_wait when in hang_calls; a step in fault_steps always raises
    CommTimeoutError. Returns (events, losses, counters, outcome)."""
    side.obs.reset()
    data = _batches(total)
    events, losses = [], []
    calls = [0]
    CommTimeout = side.res.CommTimeoutError

    def step_fn(s):
        n = calls[0]
        calls[0] += 1
        if s in fault_steps:
            raise CommTimeout("injected wedge", what="train_step")
        loss = side.step(*data[s], float("nan") if n in nan_calls else 1.0)
        losses.append((s, loss))
        side.wait(loss, n in hang_calls)
        return loss

    kw.setdefault("backoff_base", 0.001)
    kw.setdefault("backoff_cap", 0.002)
    tr = side.res.ResilientTrainer(
        side.model, side.opt, ckpt_root=str(root), backoff_seed=0,
        on_event=lambda kind, **info: events.append((kind, info)), **kw)
    try:
        outcome = tr.run(step_fn, total)
    except side.res.RestartBudgetExceededError as e:
        outcome = type(e).__name__
    counters = {k: v for k, v in side.obs.snapshot()["counters"].items()
                if k.startswith("resilient_")}
    return events, [(s, _loss_float(v)) for s, v in losses], counters, \
        outcome


CASES = {
    # one NaN: the poisoned update reaches the parameters, so the next
    # step is bad too; 2 in a row roll back to the snapshot
    "nan_loss": dict(total=7, nan_calls=(3,), snapshot_every=2,
                     max_consecutive_bad=2, ckpt_every=3),
    "consecutive_bad": dict(total=8, nan_calls=(2, 3, 4),
                            snapshot_every=1, max_consecutive_bad=3,
                            ckpt_every=4),
    "comm_timeout": dict(total=7, hang_calls=(4,), ckpt_every=3,
                         max_restarts=2),
    "budget_exhausted": dict(total=7, fault_steps=(4,), ckpt_every=3,
                             max_restarts=1),
    "before_first_checkpoint": dict(total=5, hang_calls=(1,),
                                    ckpt_every=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_under_faults_matches_jax(case, arrays, tmp_path):
    kw = dict(CASES[case])
    got = _drive(_Side("port", arrays), tmp_path / "port", **kw)
    want = _drive(_Side("jax", arrays), tmp_path / "jax", **kw)
    ev_t, ev_j = got[0], want[0]
    assert [k for k, _ in ev_t] == [k for k, _ in ev_j]
    for (k, it), (_, ij) in zip(ev_t, ev_j):
        for key in STEP_KEYS:
            assert it.get(key) == ij.get(key), (k, key, it, ij)
    assert got[2] == want[2]                   # resilient_* counters
    assert got[3] == want[3]                   # steps completed / raise
    assert [s for s, _ in got[1]] == [s for s, _ in want[1]]
    np.testing.assert_allclose([v for _, v in got[1]],
                               [v for _, v in want[1]], atol=LOSS_ATOL)
    kinds = [k for k, _ in ev_t]
    if case in ("nan_loss", "consecutive_bad"):
        assert "rollback" in kinds
    if case == "comm_timeout":
        assert "restored" in kinds and "recovery_complete" in kinds
    if case == "before_first_checkpoint":
        assert "restored_initial" in kinds
    if case == "budget_exhausted":
        assert got[3] == "RestartBudgetExceededError"


def _state(model, opt):
    """{key: tensor} of parameters, accumulators, masters (the live
    tensors, not copies)."""
    out = {f"p:{k}": t for k, t in model.state_dict().items()}
    for pid, accs in opt._accumulators.items():
        for n, v in accs.items():
            out[f"a:{pid}:{n}"] = v
    for pid, v in opt._master_weights.items():
        out[f"m:{pid}"] = v
    return out


def test_rollback_restores_in_place_bit_for_bit(arrays):
    side = _Side("port", arrays)
    data = _batches(6)
    guard = tres.BadStepGuard(side.model, side.opt, snapshot_every=1,
                              max_consecutive_bad=2,
                              on_event=lambda *a, **k: None)
    for s in range(2):
        guard.maybe_snapshot(s)
        assert guard.observe(side.step(*data[s], 1.0), s) == "good"
    guard.maybe_snapshot(2)
    want = {k: v.clone() for k, v in _state(side.model, side.opt).items()}
    ptrs = {k: v.data_ptr() for k, v in _state(side.model, side.opt).items()}
    step_count = side.opt._step_count
    assert guard.observe(side.step(*data[2], float("nan")), 2) == "skipped"
    assert not torch.isfinite(next(side.model.parameters())).all()
    guard.maybe_snapshot(3)            # mid-streak: no snapshot
    assert guard.observe(side.step(*data[3], 1.0), 3) == "rolled_back"
    got = _state(side.model, side.opt)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
        assert v.data_ptr() == ptrs[k], k        # copied into, not rebound
    assert side.opt._step_count == step_count
    assert guard.observe(side.step(*data[4], 1.0), 4) == "good"


def test_restore_from_checkpoint_in_place_bit_for_bit(arrays, tmp_path):
    side = _Side("port", arrays)
    data = _batches(4)
    tr = tres.ResilientTrainer(side.model, side.opt, ckpt_root=str(tmp_path),
                               on_event=lambda *a, **k: None)
    for s in range(2):
        side.step(*data[s], 1.0)
    tr.save(1)
    want = {k: v.clone() for k, v in _state(side.model, side.opt).items()}
    ptrs = {k: v.data_ptr() for k, v in _state(side.model, side.opt).items()}
    side.step(*data[2], 1.0)
    assert tr.restore() == 2
    got = _state(side.model, side.opt)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
        assert v.data_ptr() == ptrs[k], k
    assert side.opt._step_count == 2


# ----------------------------------------------------------------------
# the watchdog
# ----------------------------------------------------------------------

def test_watched_wait_timeout_then_late_failure_no_thread_crash():
    class WedgedWork:                   # a torch.distributed work handle
        def wait(self):
            time.sleep(0.2)
            raise RuntimeError("collective torn down after the timeout")

    with pytest.raises(twd.CommTimeoutError) as ei:
        twd.watched_wait(WedgedWork(), timeout=0.05, what="t-collective")
    assert ei.value.what == "t-collective" and ei.value.timeout == 0.05
    time.sleep(0.4)                      # let the waiter thread fail


def test_watched_wait_timeout_dumps_flight_and_mirrors_event(tmp_path,
                                                            monkeypatch):
    rec = tfr.enable_flight_recorder(out_dir=str(tmp_path), rank=0, world=1)
    try:
        rec.record("all_reduce", 512)
        monkeypatch.setattr(twd, "_block", lambda v: time.sleep(1.0))
        with pytest.raises(twd.CommTimeoutError):
            twd.watched_wait(torch.ones(2), timeout=0.05, what="t_hang")
        doc = json.load(open(os.path.join(str(tmp_path), "flight_0.json")))
        assert doc["reason"] == "comm_timeout"
        pend = [e for e in doc["entries"] if e["end_us"] is None]
        assert any(e["op"] == "wait:t_hang" for e in pend)
        ev = tobs.EVENTS.events("comm_timeout")[-1]
        assert ev["what"] == "t_hang"
        assert ev["last_seq"] == doc["last_committed_seq"]
    finally:
        tfr.disable_flight_recorder()


def test_watched_wait_flag_telemetry_and_values():
    rec = tfr.enable_flight_recorder(rank=0, world=1)
    try:
        n0 = rec.next_seq
        with tobs.disabled_scope():
            twd.watched_wait(torch.ones(2), timeout=5, what="t_off")
        assert rec.next_seq == n0
        t = torch.ones(3)
        assert twd.watched_wait([t, {"a": t}], timeout=5, what="t_on") \
            == [t, {"a": t}]
        assert rec.entries()[-1]["op"] == "wait:t_on"
        assert rec.entries()[-1]["end_us"] is not None
    finally:
        tfr.disable_flight_recorder()
    # FLAGS_comm_timeout_s is read when timeout is None
    set_flags({"FLAGS_comm_timeout_s": 0.05})
    try:
        class Slow:
            def wait(self):
                time.sleep(0.3)
        with pytest.raises(twd.CommTimeoutError):
            twd.watched_wait(Slow())
    finally:
        set_flags({"FLAGS_comm_timeout_s": 0.0})
    fired = []
    with twd.watch("region", timeout=0.05, on_timeout=fired.append):
        time.sleep(0.2)
    assert fired and "region" in fired[0]


# ----------------------------------------------------------------------
# elastic: heartbeats, the peer watch, the re-rendezvous (two ranks)
# ----------------------------------------------------------------------

class _Store:
    """Dict-backed store shared by the ranks (get/set/add)."""

    def __init__(self, data, lock):
        self.data, self.lock = data, lock

    def set(self, key, value):
        with self.lock:
            self.data[key] = value if isinstance(value, bytes) \
                else str(value).encode()

    def get(self, key):
        with self.lock:
            if key not in self.data:
                raise KeyError(key)
            return self.data[key]

    def add(self, key, amount):
        with self.lock:
            v = int(self.data.get(key, b"0")) + int(amount)
            self.data[key] = str(v).encode()
            return v


def _env(rank, world):
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(world)


@pytest.fixture
def two_ranks():
    yield
    os.environ.pop("PADDLE_TRAINER_ID", None)
    os.environ.pop("PADDLE_TRAINERS_NUM", None)


def test_elastic_watch_dead_peer_matches_jax(two_ranks):
    from paddle_tpu.distributed.fleet.elastic import \
        ElasticManager as JaxElasticManager
    verdicts = {}
    for name, cls in (("jax", JaxElasticManager), ("port", ElasticManager)):
        data, lock = {}, threading.Lock()
        _env(0, 2)
        mgr = cls(store=_Store(data, lock), heartbeat_interval=0.01,
                  join_timeout=0.05)
        seq = [mgr.watch()]                  # peer never joined, in time
        time.sleep(0.08)
        seq.append(mgr.watch())              # never joined: restart
        data["heartbeat/1"] = b"1"
        mgr2 = cls(store=_Store(data, lock), heartbeat_interval=0.01)
        seq.append(mgr2.watch())             # baseline
        data["heartbeat/1"] = b"2"
        seq.append(mgr2.watch())             # beat moved: hold
        time.sleep(0.05)
        seq.append(mgr2.watch())             # stale past 3 intervals
        mgr2.start_heartbeat()
        time.sleep(0.03)
        seq.append(data.get("heartbeat/0") is not None)
        mgr2.stop()
        verdicts[name] = seq
    assert verdicts["port"] == verdicts["jax"]
    assert verdicts["port"][:5] == [ElasticStatus.HOLD,
                                    ElasticStatus.RESTART,
                                    ElasticStatus.HOLD, ElasticStatus.HOLD,
                                    ElasticStatus.RESTART]


def test_trainer_peer_watch_raises_peer_failure(tmp_path, two_ranks):
    data, lock = {}, threading.Lock()
    _env(0, 2)
    data["heartbeat/1"] = b"42"              # the peer joined once
    mgr = ElasticManager(store=_Store(data, lock), heartbeat_interval=0.01)
    model = torch.nn.Linear(2, 1)
    tr = tres.ResilientTrainer(model, None, ckpt_root=str(tmp_path),
                               elastic=mgr, recover="raise",
                               on_event=lambda *a, **k: None)
    mgr.watch()
    time.sleep(0.1)                          # ...and never beats again

    def step(s):
        time.sleep(0.02)
        return 0.0

    with pytest.raises(tres.PeerFailureError):
        tr.run(step, 100)


def test_rerendezvous_two_ranks_and_timeout(tmp_path):
    data, lock = {}, threading.Lock()
    events = {0: [], 1: []}
    trainers = [tres.ResilientTrainer(
        torch.nn.Linear(2, 1), None, ckpt_root=str(tmp_path),
        store=_Store(data, lock), rank=r, world_size=2, barrier_timeout=5.0,
        on_event=lambda kind, r=r, **info: events[r].append((kind, info)))
        for r in range(2)]
    th = [threading.Thread(target=t._rerendezvous) for t in trainers]
    for t in th:
        t.start()
    for t in th:
        t.join(10)
    for r in range(2):
        assert [k for k, _ in events[r]] == ["rerendezvous"]
        assert events[r][0][1] == {"generation": -1, "world": 2}
    assert data["resilient/gen/-1/arrived"] == b"2"

    class LonelyStore:
        def add(self, key, amount):
            return 1                         # only this rank arrives
    got = {}
    for name, mod in (("jax", jres), ("port", tres)):
        ev = []
        model = paddle.nn.Linear(2, 1) if name == "jax" else \
            torch.nn.Linear(2, 1)
        tr = mod.ResilientTrainer(
            model, None, ckpt_root=str(tmp_path / name),
            store=LonelyStore(), world_size=2, barrier_timeout=0.2,
            on_event=lambda kind, ev=ev, **info: ev.append(kind))
        tr._rerendezvous()
        got[name] = ev
    assert got["port"] == got["jax"] == ["rerendezvous_timeout"]
    # one process: both are no-ops
    solo = tres.ResilientTrainer(torch.nn.Linear(2, 1), None,
                                 ckpt_root=str(tmp_path / "solo"),
                                 store=_Store({}, lock), world_size=1,
                                 on_event=lambda *a, **k: None)
    solo._rerendezvous()
    solo._check_peers()
