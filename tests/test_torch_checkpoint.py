"""The port's checkpoints (``paddle_tpu_torch.distributed.checkpoint``)
against the JAX package's (``paddle_tpu.distributed.checkpoint``): the
same files, so that one package's checkpoint loads into the other.

- The same state (float32, bfloat16, int64, 0-dim, a Python scalar)
  saved by both packages gives the same metadata.json (crc32s included)
  and the same .npy files, byte for byte; bfloat16 loads bit-exactly both
  ways.
- A tiny Llama and its AdamW state, trained 2 steps by the JAX package and
  saved, load into a fresh port model and optimizer (the optimizer's
  tensors sized from the checkpoint's metadata, then
  ``set_state_dict``), and the next 3 ``compile_train_step`` losses equal
  the JAX package's own continuation within 1e-4 (float32 products in
  other orders, as in ``test_torch_train.py``); the reverse too.
- Integrity: a flipped byte in a shard raises ``CheckpointCorruptError``;
  ``find_latest_valid`` skips a corrupt and a partial (no metadata.json)
  step directory; ``save_checkpoint`` moves ``LATEST`` and keeps the last
  n; ``async_save`` writes the values of the moment it was called.
"""

import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu import jit as jjit
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.jit import compile_train_step
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((4, 6)).astype(np.float32),
        "b16": rng.standard_normal((3, 5)).astype(np.float32),
        "ids": rng.integers(0, 1000, (7,)),
        "pow": np.float32(0.9),
    }


def _jax_state():
    a = _arrays()
    return {"w": paddle.to_tensor(a["w"]),
            "b16": paddle.to_tensor(jnp.asarray(a["b16"], jnp.bfloat16)),
            "ids": paddle.to_tensor(a["ids"]),
            "pow": paddle.to_tensor(jnp.asarray(a["pow"])),
            "@step": 3}


def _port_state():
    a = _arrays()
    return {"w": torch.from_numpy(a["w"]),
            "b16": torch.from_numpy(a["b16"]).bfloat16(),
            "ids": torch.from_numpy(a["ids"]),
            "pow": torch.tensor(a["pow"]),
            "@step": 3}


def test_same_files_as_jax(tmp_path):
    jckpt.save_state_dict(_jax_state(), str(tmp_path / "j"))
    tckpt.save_state_dict(_port_state(), str(tmp_path / "t"))
    meta = [json.loads((tmp_path / d / "metadata.json").read_text())
            for d in ("j", "t")]
    assert meta[0] == meta[1]
    assert meta[1]["b16"]["stored_as"] == "bfloat16-as-uint16"
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t"))
    for f in files:
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f


def test_bfloat16_bit_exact_both_ways(tmp_path):
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2 ** 16, (8, 8), dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0x3F80     # no NaN or inf patterns
    t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    tckpt.save_state_dict({"x": t}, str(tmp_path / "t"))
    jt = paddle.to_tensor(jnp.zeros((8, 8), jnp.bfloat16))
    jckpt.load_state_dict({"x": jt}, str(tmp_path / "t"))
    assert np.array_equal(np.asarray(jt._value).view(np.uint16), bits)
    jckpt.save_state_dict({"x": jt}, str(tmp_path / "j"))
    back = torch.zeros(8, 8, dtype=torch.bfloat16)
    assert tckpt.load_state_dict({"x": back}, str(tmp_path / "j")) == []
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))


def _batch():
    rng = np.random.default_rng(7)
    return rng.integers(0, 128, (2, 16)), rng.integers(0, 128, (2, 16))


def _jax_pair():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny())
    return jm, jopt.AdamW(1e-3, parameters=jm.parameters())


def _jax_step(jm, jo):
    """The JAX train step. It takes the optimizer's state when it is made
    and keeps it to itself until ``sync_optimizer_state``: make it after a
    load, and sync it before a save."""
    return jjit.compile_train_step(jm, lambda m, i, l: m(i, labels=l), jo)


def _port_pair(seed):
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    weights.from_paddle_tpu_state(weights.random_state(tm, seed), tm)
    to = topt.AdamW(1e-3, parameters=tm.parameters())
    return tm, to, compile_train_step(tm, lambda m, i, l: m(i, labels=l),
                                      to)


def _template(path, make):
    """{key: zeros of the saved shape and type} for every tensor entry of
    the checkpoint's metadata (the optimizer's state, before its first
    step, has no tensors to load into)."""
    meta = json.loads((path / "metadata.json").read_text())
    return {k: make(e["global_shape"], e["dtype"]) for k, e in meta.items()
            if not e.get("py")}


def test_jax_checkpoint_continues_on_the_port(tmp_path):
    ids, lab = _batch()
    jm, jo = _jax_pair()
    jstep = _jax_step(jm, jo)
    for _ in range(2):
        jstep(paddle.to_tensor(ids), paddle.to_tensor(lab))
    jstep.sync_optimizer_state()
    jsd = {**jm.state_dict(), **jo.state_dict()}
    jckpt.save_state_dict(jsd, str(tmp_path / "ck"))
    want = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(lab)))
            for _ in range(3)]

    tm, to, tstep = _port_pair(seed=1)
    sd = _template(tmp_path / "ck", lambda s, d: torch.zeros(
        s, dtype=getattr(torch, d)))
    sd.update(tm.state_dict())
    sd["@step"] = 0
    assert tckpt.load_state_dict(sd, str(tmp_path / "ck")) == []
    to.set_state_dict(sd)
    assert to.state_dict()["@step"] == 2
    got = [float(tstep(torch.from_numpy(ids), torch.from_numpy(lab)))
           for _ in range(3)]
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_port_checkpoint_continues_on_jax(tmp_path):
    ids, lab = _batch()
    jm, jo = _jax_pair()
    tm, to, tstep = _port_pair(seed=1)
    weights.from_paddle_tpu_state(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()}, tm)
    for _ in range(2):
        tstep(torch.from_numpy(ids), torch.from_numpy(lab))
    tckpt.save_state_dict({**tm.state_dict(), **to.state_dict()},
                          str(tmp_path / "ck"))
    want = [float(tstep(torch.from_numpy(ids), torch.from_numpy(lab)))
            for _ in range(3)]

    sd = _template(tmp_path / "ck", lambda s, d: paddle.to_tensor(
        jnp.zeros(s, jnp.dtype(d))))
    sd.update(jm.state_dict())
    assert jckpt.load_state_dict(sd, str(tmp_path / "ck")) == []
    jo.set_state_dict(sd)
    jstep = _jax_step(jm, jo)
    got = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(lab)))
           for _ in range(3)]
    np.testing.assert_allclose(got, want, atol=1e-4)


def _flip_a_byte(path):
    f = sorted(p for p in os.listdir(path) if p.endswith(".npy"))[0]
    raw = bytearray(open(os.path.join(path, f), "rb").read())
    raw[-1] ^= 0xFF
    open(os.path.join(path, f), "wb").write(bytes(raw))


def test_corruption_is_refused_and_skipped(tmp_path):
    root = str(tmp_path)
    for step in (10, 20, 30):
        st = _port_state()
        st["w"] = st["w"] + step
        tckpt.save_checkpoint(st, root, step, keep_last_n=5)
    assert tckpt.read_latest(root) == (30, tckpt.checkpoint_dir(root, 30))
    assert [s for s, _ in tckpt.list_checkpoints(root)] == [10, 20, 30]
    _flip_a_byte(tckpt.checkpoint_dir(root, 30))
    ok, reason = tckpt.verify_checkpoint(tckpt.checkpoint_dir(root, 30))
    assert not ok and "crc32" in reason
    with pytest.raises(tckpt.CheckpointCorruptError):
        tckpt.load_state_dict(_port_state(), tckpt.checkpoint_dir(root, 30))
    os.remove(os.path.join(tckpt.checkpoint_dir(root, 20), "metadata.json"))
    assert tckpt.find_latest_valid(root) == (10, tckpt.checkpoint_dir(root,
                                                                      10))
    # the JAX package agrees on which directory is the latest valid one
    assert jckpt.find_latest_valid(root) == tckpt.find_latest_valid(root)
    target = _port_state()
    assert tckpt.load_latest(target, root) == (10, tckpt.checkpoint_dir(
        root, 10))
    assert torch.equal(target["w"], _port_state()["w"] + 10)
    assert tckpt.find_latest_valid(root, committed_only=True)[0] == 10


def test_retention_and_async_save(tmp_path):
    root = str(tmp_path)
    st = _port_state()
    handles = []
    for step in range(1, 5):
        st["w"].fill_(float(step))
        handles.append(tckpt.save_checkpoint(st, root, step,
                                             async_save=True, keep_last_n=2))
        st["w"].fill_(-1.0)        # after the call: not in the files
    tckpt.wait_async_save()
    assert all(h.done() for h in handles)
    assert [s for s, _ in tckpt.list_checkpoints(root)] == [3, 4]
    target = _port_state()
    assert tckpt.load_latest(target, root)[0] == 4
    assert float(target["w"].min()) == float(target["w"].max()) == 4.0
    assert target["@step"] == 3
    with pytest.raises(TypeError, match="non-checkpointable"):
        tckpt.save_state_dict({"bad": {"a": 1}}, str(tmp_path / "x"))
    with pytest.raises(NotImplementedError, match="world_size"):
        tckpt.save_checkpoint(st, root, 9, world_size=2)
