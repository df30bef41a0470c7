"""The checkpoint's multi-host commit barrier in the port against the JAX
package's (``tests/test_fault_tolerance.py:159-210``): LATEST moves only
after every rank has posted its progress in the same lineage; a stale
lineage never satisfies it; a peer ahead does; a dead peer times out. The
``.progress.<rank>`` files are the JAX package's bytes, so a JAX rank and
a port coordinator share one barrier."""

import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.distributed.checkpoint as jck

import paddle_tpu_torch.distributed.checkpoint as tck


def _state():
    return {"w": torch.arange(8, dtype=torch.float32), "step": 3}


def test_commit_barrier_multihost(tmp_path):
    """The coordinator's save blocks at the barrier until the last rank
    posts; LATEST is not there before."""
    root = str(tmp_path)
    committed = threading.Event()

    def rank0():
        tck.save_checkpoint(_state(), root, 0, world_size=2, rank=0,
                            barrier_timeout=30.0)
        committed.set()

    t = threading.Thread(target=rank0)
    t.start()
    time.sleep(0.3)
    assert not committed.is_set()
    assert tck.read_latest(root) is None
    tck.save_checkpoint(_state(), root, 0, world_size=2, rank=1)
    t.join(30.0)
    assert committed.is_set()
    assert tck.read_latest(root)[0] == 0
    assert tck.read_progress(root, 0) == tck.read_progress(root, 1) == \
        ("-", 0)
    target = {"w": torch.zeros(8)}
    assert tck.load_latest(target, root, committed_only=True)[0] == 0
    assert torch.equal(target["w"], torch.arange(8, dtype=torch.float32))


def test_commit_barrier_ignores_stale_posts_from_aborted_attempt(tmp_path):
    tck.post_progress(str(tmp_path), 1, "r-1", 5)     # stale lineage
    with pytest.raises(TimeoutError, match="lineage r4"):
        tck.save_checkpoint(_state(), str(tmp_path), 5, world_size=2,
                            rank=0, barrier_timeout=0.3, barrier_tag="r4")
    assert tck.read_latest(str(tmp_path)) is None


def test_commit_barrier_satisfied_by_peer_ahead_in_same_lineage(tmp_path):
    tck.post_progress(str(tmp_path), 1, "r4", 9)      # the peer is ahead
    tck.save_checkpoint(_state(), str(tmp_path), 5, world_size=2, rank=0,
                        barrier_timeout=5.0, barrier_tag="r4")
    assert tck.read_latest(str(tmp_path))[0] == 5


def test_commit_barrier_times_out_when_peer_dies(tmp_path):
    with pytest.raises(TimeoutError):
        tck.save_checkpoint(_state(), str(tmp_path), 0, world_size=2,
                            rank=0, barrier_timeout=0.3)
    assert tck.read_latest(str(tmp_path)) is None


def test_progress_files_are_the_jax_packages(tmp_path):
    """Both packages write the same bytes and read each other's."""
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    jck.post_progress(str(a), 3, "r7", 12)
    tck.post_progress(str(b), 3, "r7", 12)
    assert (a / ".progress.3").read_bytes() == \
        (b / ".progress.3").read_bytes() == b"r7:12"
    assert tck.read_progress(str(a), 3) == jck.read_progress(str(b), 3) == \
        ("r7", 12)
    assert tck.read_progress(str(a), 4) is None


def test_jax_rank_and_port_coordinator_share_the_barrier(tmp_path):
    """A JAX rank posts its progress (``post_progress`` of the JAX
    package) while the port's coordinator waits at the barrier: the port
    commits LATEST on it, and the JAX package reads the commit."""
    root = str(tmp_path)
    done = threading.Event()

    def coordinator():
        tck.save_checkpoint(_state(), root, 4, world_size=2, rank=0,
                            barrier_timeout=30.0, barrier_tag="r2")
        done.set()

    t = threading.Thread(target=coordinator)
    t.start()
    time.sleep(0.3)
    assert not done.is_set() and jck.read_latest(root) is None
    jck.post_progress(root, 1, "r2", 4)
    t.join(30.0)
    assert done.is_set()
    assert jck.read_latest(root)[0] == tck.read_latest(root)[0] == 4
    step, path = jck.find_latest_valid(root, committed_only=True)
    assert step == 4 and path == jck.checkpoint_dir(root, 4) == \
        tck.checkpoint_dir(root, 4)
    np.testing.assert_array_equal(
        np.load(os.path.join(path, "w__0.npy")), np.arange(8, dtype="f4"))
