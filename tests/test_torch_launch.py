"""The port's launch CLI, TCPStore, spawn and gloo helpers against the JAX
package's (``tests/test_checkpoint_launch.py:77, 92, 240``,
``tests/test_native_runtime.py``'s store tests). Workers are real
processes on the loopback; ports are chosen free by the test."""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

import paddle_tpu.distributed as jdist

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.distributed.store import TCPStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID", "PADDLE_NNODES",
            "PADDLE_MASTER", "MASTER_ADDR", "MASTER_PORT",
            "CUDA_VISIBLE_DEVICES")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(package, *args, env=None, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", f"{package}.distributed.launch", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=env)


def test_launch_cli_sets_the_jax_launchers_environment(tmp_path):
    """Both launchers run a script that dumps its environment: the same
    world variables, the same workerlog file, exit code 0."""
    script = tmp_path / "env.py"
    script.write_text(
        "import json, os, sys\n"
        f"keys = {ENV_KEYS!r}\n"
        "json.dump({k: os.environ.get(k) for k in keys},\n"
        "          open(sys.argv[1], 'w'))\n"
        "print('TRAINED')\n")
    got = {}
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        out = tmp_path / f"{pkg}.json"
        logs = tmp_path / f"logs_{pkg}"
        env = dict(os.environ)
        env.pop("CUDA_VISIBLE_DEVICES", None)
        ret = _launch(pkg, "--nnodes", "2", "--rank", "1", "--master",
                      "10.0.0.1:6170", "--devices", "0,1", "--log_dir",
                      str(logs), str(script), str(out), env=env)
        assert ret.returncode == 0, ret.stderr
        assert "TRAINED" in (logs / "workerlog.1.0").read_text()
        got[pkg] = json.load(open(out))
    assert got["paddle_tpu_torch"] == got["paddle_tpu"]
    assert got["paddle_tpu_torch"]["MASTER_PORT"] == "6170"
    assert got["paddle_tpu_torch"]["CUDA_VISIBLE_DEVICES"] == "0,1"


def test_launch_cli_elastic_restart(tmp_path):
    """--elastic_level 1 starts a failed worker again: the second
    attempt's log is workerlog.0.1."""
    script = tmp_path / "flaky.py"
    marker = tmp_path / "marker"
    script.write_text(f"import os, sys\nm = {str(marker)!r}\n"
                      "if not os.path.exists(m):\n"
                      "    open(m, 'w').close()\n"
                      "    sys.exit(1)\n"
                      "print('RECOVERED')\n")
    ret = _launch("paddle_tpu_torch", "--elastic_level", "1",
                  "--max_restart", "2", "--log_dir", str(tmp_path / "logs"),
                  str(script))
    assert ret.returncode == 0, ret.stderr
    assert "restart 1/2" in ret.stderr
    assert "RECOVERED" in (tmp_path / "logs" / "workerlog.0.1").read_text()


def test_launch_cli_fails_fast_with_the_workers_code(tmp_path):
    script = tmp_path / "bad.py"
    script.write_text("import sys\nsys.exit(7)\n")
    ret = _launch("paddle_tpu_torch", "--log_dir", str(tmp_path / "logs"),
                  str(script))
    assert ret.returncode == 7
    assert "worker failed with code 7" in ret.stderr
    assert not (tmp_path / "logs" / "workerlog.0.1").exists()


_W0 = """
import os, sys, time
sys.path.insert(0, {repo!r})
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                        ElasticStatus)
store = TCPStore(host="127.0.0.1", port={port}, is_master=True)
mgr = ElasticManager(store=store, heartbeat_interval=0.1)
mgr.start_heartbeat()
store.wait("heartbeat/1", timeout=120)
deadline = time.time() + 60
status = ElasticStatus.HOLD
while time.time() < deadline:
    status = mgr.watch()
    if status == ElasticStatus.RESTART:
        print("PEER_FAILURE_DETECTED", flush=True)
        break
    time.sleep(0.1)
mgr.stop()
store.close()
sys.exit(0 if status == ElasticStatus.RESTART else 3)
"""

_W1 = """
import sys, time
sys.path.insert(0, {repo!r})
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
store = TCPStore(host="127.0.0.1", port={port}, is_master=False,
                 timeout=60)
mgr = ElasticManager(store=store, heartbeat_interval=0.1)
mgr.start_heartbeat()
print("W1_UP", flush=True)
time.sleep(60)
"""


def test_launch_two_procs_kill_one_detected(tmp_path):
    """Two workers under the launch CLI share the port's TCPStore; the
    test kills worker 1 and worker 0's ElasticManager sees the stale
    heartbeat (tests/test_checkpoint_launch.py:240)."""
    port = _free_port()
    w0, w1 = tmp_path / "w0.py", tmp_path / "w1.py"
    w0.write_text(_W0.format(repo=REPO, port=port))
    w1.write_text(_W1.format(repo=REPO, port=port))
    procs = []
    for r, w in ((0, w0), (1, w1)):
        env = dict(os.environ, PADDLE_TRAINER_ID=str(r),
                   PADDLE_TRAINERS_NUM="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nnodes", "2", "--rank", str(r), "--log_dir",
             str(tmp_path / f"l{r}"), str(w)], cwd=REPO, env=env,
            start_new_session=True))
    log1 = tmp_path / "l1" / "workerlog.1.0"
    try:
        deadline = time.time() + 90
        while time.time() < deadline and not (
                log1.exists() and "W1_UP" in log1.read_text()):
            time.sleep(0.1)
        assert "W1_UP" in log1.read_text()
        time.sleep(0.5)
        os.killpg(procs[1].pid, 9)           # the launcher and its worker
        assert procs[0].wait(timeout=90) == 0
        assert "PEER_FAILURE_DETECTED" in (
            tmp_path / "l0" / "workerlog.0.0").read_text()
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)


def test_tcp_store_set_get_add():
    store = TCPStore(is_master=True)
    try:
        assert store.port > 0
        store.set("alpha", b"value1")
        assert store.get("alpha") == b"value1"
        store.set("beta", "text")
        assert store.get("beta") == b"text"
        with pytest.raises(KeyError):
            store.get("missing")
        assert store.add("counter", 3) == 3
        assert store.add("counter", 4) == 7
    finally:
        store.close()


def test_tcp_store_two_clients_rendezvous():
    master = TCPStore(is_master=True)
    try:
        worker = TCPStore(port=master.port)
        worker.set("rank1_addr", b"10.0.0.2:1234")
        master.wait(["rank1_addr"])
        assert master.get("rank1_addr") == b"10.0.0.2:1234"
        assert master.add("barrier", 1) == 1
        assert worker.add("barrier", 1) == 2
        worker.close()
    finally:
        master.close()


def test_tcp_store_wait_blocks_until_set_and_times_out():
    master = TCPStore(is_master=True)
    try:
        def late():
            s = TCPStore(port=master.port)
            time.sleep(0.3)
            s.set("late_key", b"arrived")
            s.close()
        t0 = time.time()
        th = threading.Thread(target=late)
        th.start()
        master.wait("late_key")
        assert time.time() - t0 >= 0.25
        assert master.get("late_key") == b"arrived"
        th.join(5)
        t0 = time.time()
        with pytest.raises(TimeoutError):
            master.wait(["never"], timeout=0.3)
        assert 0.25 <= time.time() - t0 < 10
    finally:
        master.close()


def test_spawn_calls_func_once_as_jax_does():
    calls = {"jax": [], "port": []}
    jdist.spawn(lambda *a: calls["jax"].append(a), args=(1, "x"), nprocs=4)
    tdist.spawn(lambda *a: calls["port"].append(a), args=(1, "x"),
                nprocs=4)
    assert calls["port"] == calls["jax"] == [(1, "x")]


def test_gloo_helpers_one_rank_as_jax():
    """One rank: gloo_init_parallel_env is init_parallel_env, the barrier
    and the release run, as in the JAX package."""
    prev = tdevice._CURRENT[0]
    ptt.set_device("cpu")
    tdist.destroy_process_group()
    try:
        jdist.gloo_init_parallel_env(0, 1, "127.0.0.1:0")
        tdist.gloo_init_parallel_env(0, 1, "127.0.0.1:0")
        assert tdist.is_initialized() and jdist.is_initialized()
        jdist.gloo_barrier()
        tdist.gloo_barrier()
        jdist.gloo_release()
        tdist.gloo_release()
        assert tdist.get_backend() == "nccl"
        assert tdist.get_rank() == jdist.get_rank() == 0
    finally:
        tdist.destroy_process_group()
        tdevice._CURRENT[0] = prev


_GLOO = """
import sys
sys.path.insert(0, {repo!r})
import torch
import paddle_tpu_torch as ptt
ptt.set_device("cpu")
import paddle_tpu_torch.distributed as dist
r = int(sys.argv[1])
dist.gloo_init_parallel_env(r, 2, "127.0.0.1:{port}")
assert dist.get_backend() == "gloo" and dist.get_rank() == r
t = torch.tensor([r + 1.0])
dist.all_reduce(t)
dist.gloo_barrier()
dist.gloo_release()
assert not dist.is_initialized()
print("GLOO_OK", float(t), flush=True)
"""


def test_gloo_helpers_two_ranks(tmp_path):
    """Two ranks: gloo_init_parallel_env joins the gloo world at the
    endpoint, gloo_release leaves it."""
    w = tmp_path / "g.py"
    w.write_text(_GLOO.format(repo=REPO, port=_free_port()))
    procs = [subprocess.Popen([sys.executable, str(w), str(r)], cwd=REPO,
                              stdout=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all("GLOO_OK 3.0" in o for o in outs)


def test_init_parallel_env_needs_a_master(monkeypatch):
    """WORLD_SIZE 2 with no master address raises (nothing falls back to
    one process)."""
    tdist.destroy_process_group()
    for k in ("PADDLE_MASTER", "MASTER_ADDR", "PADDLE_TRAINERS_NUM"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="master"):
        tdist.init_parallel_env(devices="cpu")
    assert not tdist.is_initialized()


def test_new_modules_import_neither_jax_nor_paddle_tpu():
    """The slice's modules, imported in a fresh process, bring in neither
    JAX nor the JAX package."""
    code = ("import sys\n"
            "import paddle_tpu_torch.distributed\n"
            "import paddle_tpu_torch.distributed.launch\n"
            "import paddle_tpu_torch.distributed.multihost\n"
            "import paddle_tpu_torch.distributed.auto_tuner\n"
            "import paddle_tpu_torch.distributed.store\n"
            "import paddle_tpu_torch.ops.ring_attention\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    ret = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert ret.returncode == 0, ret.stdout + ret.stderr
