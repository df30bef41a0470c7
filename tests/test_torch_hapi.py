"""``hapi``, ``metric`` and ``save`` / ``load`` of the port against the
JAX package's, on the CPU:

- ``Model.fit`` (shuffled batches from numpy's global seed, a Momentum
  step per batch, the extra eval-mode forward for the metrics after each
  step), ``evaluate``, ``predict`` and ``summary``: the same loss history
  (1e-5 relative), metrics, predictions and counts as the JAX ``Model``
  on a small network with the same weights;
- the JAX test's separable problem (``tests/test_vision_e2e.py:64-98``:
  the class is the bright quadrant) on a ResNet-18 at 32 images through
  ``Model.train_batch``: 12 Momentum losses equal to JAX's at rtol 1e-4,
  in float64 (in float32 this training amplifies the first step's 1e-7
  differences to 1e-3 by the second loss);
- ``Model.save`` / ``load`` and ``paddle.save`` / ``load``: a
  ``.pdparams`` and a ``.pdopt`` written by either package load in the
  other, with bit-equal values; nested containers and bfloat16;
- the callbacks (``ModelCheckpoint``, ``EarlyStopping``,
  ``LRScheduler``) and the metrics (``Accuracy`` top-k, ``Precision``,
  ``Recall``, ``Auc``, ``accuracy``) against the JAX ones;
- a fresh interpreter importing the slice's modules loads neither
  ``jax`` nor ``paddle_tpu``.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import hapi as jhapi
from paddle_tpu import metric as jmetric
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu.vision import models as jm

import paddle_tpu_torch as ptt
from paddle_tpu_torch import hapi, metric, nn, weights
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.vision import models as tm
from torch_parity import cpu_device, to_np  # noqa: F401

torch.set_num_threads(1)


def _data(n=40, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, 6)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.int64) + 2 * (x[:, 2] > 0)
    return x, y.astype(np.int64)


def _nets(seed=1):
    paddle.seed(seed)
    j = jnn.Sequential(jnn.Linear(6, 16), jnn.ReLU(), jnn.Linear(16, 4))
    t = nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 4))
    weights.from_paddle_tpu_state(
        {n: np.asarray(p._value) for n, p in j.named_parameters()}, t)
    return j, t


def _models(j, t, lr=0.1):
    jmodel = jhapi.Model(j).prepare(
        jopt.Momentum(lr, parameters=j.parameters()), jnn.CrossEntropyLoss(),
        jmetric.Accuracy(topk=(1, 2)))
    tmodel = hapi.Model(t).prepare(
        topt.Momentum(lr, parameters=t.parameters()), nn.CrossEntropyLoss(),
        metric.Accuracy(topk=(1, 2)))
    return jmodel, tmodel


def test_fit_evaluate_predict_summary_match_jax(capsys):
    x, y = _data()
    j, t = _nets()
    jmodel, tmodel = _models(j, t)
    jtrain = JTensorDataset([paddle.to_tensor(x), paddle.to_tensor(y)])
    ttrain = TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    np.random.seed(3)
    jh = jmodel.fit(jtrain, jtrain, batch_size=8, epochs=2, verbose=0)
    np.random.seed(3)
    th = tmodel.fit(ttrain, ttrain, batch_size=8, epochs=2, verbose=0)
    assert len(th["loss"]) == len(jh["loss"]) == 10
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    je, te = jmodel.evaluate(jtrain, batch_size=16), \
        tmodel.evaluate(ttrain, batch_size=16)
    assert sorted(te) == sorted(je) == ["acc_top1", "loss"]
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-5)
    np.testing.assert_allclose(te["acc_top1"], je["acc_top1"])
    jp = jmodel.predict(jtrain, batch_size=16, stack_outputs=True)[0]
    tp = tmodel.predict(ttrain, batch_size=16, stack_outputs=True)[0]
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)
    assert len(tmodel.predict(ttrain, batch_size=16)[0]) == 3
    assert tmodel.summary() == jmodel.summary() == {
        "total_params": 180, "trainable_params": 180}
    assert ptt.summary is hapi.summary and ptt.Model is hapi.Model
    assert "Total params: 180" in capsys.readouterr().out


def test_fit_with_num_iters_and_verbose_logs(capsys):
    x, y = _data(24)
    _, t = _nets()
    tmodel = hapi.Model(t).prepare(
        topt.SGD(0.05, parameters=t.parameters()), nn.CrossEntropyLoss(),
        metric.Accuracy())
    h = tmodel.fit(TensorDataset([torch.from_numpy(x), torch.from_numpy(y)]),
                   batch_size=4, epochs=3, num_iters=4, log_freq=2,
                   verbose=2)
    out = capsys.readouterr().out
    assert len(h["loss"]) == 4 and "Epoch 0 step 2: loss:" in out and \
        "acc:" in out and "Epoch 1" not in out


def test_resnet18_separable_problem_twelve_losses_match_jax():
    """The JAX test's data and initialization (numpy seed 42, paddle.seed
    42), the JAX model's weights carried into the port."""
    np.random.seed(42)
    n = 32
    X = np.random.rand(n, 3, 32, 32).astype("float32") * 0.1
    Y = np.random.randint(0, 4, n).astype("int64")
    for i, lab in enumerate(Y):
        h, w = (lab // 2) * 16, (lab % 2) * 16
        X[i, :, h:h + 16, w:w + 16] += 0.8
    X = X.astype("float64")
    paddle.seed(42)
    j = jm.ResNet(jm.BasicBlock, 18, num_classes=4)
    t = tm.ResNet(tm.BasicBlock, 18, num_classes=4)
    arrays = {n: np.asarray(v.numpy()) for n, v in j.state_dict().items()}
    weights.from_paddle_tpu_state(arrays, t)
    j.astype("float64")
    t.astype("float64")
    for m in j.sublayers() + t.sublayers():
        if isinstance(m, (jnn.BatchNorm2D, nn.BatchNorm2D)):
            m.momentum = 0.2
    jmodel = jhapi.Model(j).prepare(
        jopt.Momentum(0.05, parameters=j.parameters()),
        jnn.CrossEntropyLoss())
    tmodel = hapi.Model(t).prepare(
        topt.Momentum(0.05, parameters=t.parameters()),
        nn.CrossEntropyLoss())
    jx, jy = paddle.to_tensor(X), paddle.to_tensor(Y)
    tx, ty = torch.from_numpy(X), torch.from_numpy(Y)
    jl = [float(jmodel.train_batch([jx], [jy])[0]) for _ in range(12)]
    tl = [float(tmodel.train_batch([tx], [ty])[0]) for _ in range(12)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < 0.5 * tl[0]


def test_pdparams_and_pdopt_cross_load_both_ways(tmp_path):
    x, y = _data(16)
    j, t = _nets(2)
    jmodel, tmodel = _models(j, t)
    jmodel.train_batch([paddle.to_tensor(x)], [paddle.to_tensor(y)])
    tmodel.train_batch([torch.from_numpy(x)], [torch.from_numpy(y)])
    jpath, tpath = str(tmp_path / "j" / "m"), str(tmp_path / "t" / "m")
    jmodel.save(jpath)
    tmodel.save(tpath)
    # JAX -> port
    j2, t2 = _nets(5)
    _, tload = _models(j2, t2)
    tload.load(jpath)
    for n, p in t2.named_parameters():
        np.testing.assert_array_equal(
            p.detach().numpy(), to_np(dict(j.named_parameters())[n]))
    assert int(tload._optimizer.state_dict()["@step"]) == 1
    vel = {k: v for k, v in tload._optimizer.state_dict().items()
           if k.endswith("velocity")}
    assert sorted(vel) == ["param_0.velocity", "param_1.velocity",
                           "param_2.velocity", "param_3.velocity"]
    # port -> JAX
    j3, t3 = _nets(6)
    jload, _ = _models(j3, t3)
    jload.load(tpath)
    for n, p in j3.named_parameters():
        np.testing.assert_array_equal(
            to_np(p), dict(t.named_parameters())[n].detach().numpy())
    for k, v in tmodel._optimizer.state_dict().items():
        if k.endswith("velocity"):
            np.testing.assert_array_equal(
                to_np(jload._optimizer.state_dict()[k]), v.numpy())
    # the files are plain numpy pickles
    with open(tpath + ".pdparams", "rb") as f:
        raw = pickle.load(f)
    assert all(isinstance(v, np.ndarray) for v in raw.values())


def test_save_load_containers_and_bf16(tmp_path):
    obj = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
           "nested": [torch.ones(2, dtype=torch.int64),
                      (torch.tensor(1.5, dtype=torch.float64), "s", 3)],
           "b16": torch.tensor([1.0, -2.5, 3.25], dtype=torch.bfloat16)}
    path = str(tmp_path / "sub" / "obj.pdparams")
    ptt.save(obj, path)
    got = ptt.load(path)
    assert torch.equal(got["w"], obj["w"]) and \
        torch.equal(got["nested"][0], obj["nested"][0])
    assert isinstance(got["nested"][1], tuple) and \
        got["nested"][1][1:] == ("s", 3)
    assert got["nested"][1][0].dtype == torch.float64
    assert got["b16"].dtype == torch.bfloat16 and \
        torch.equal(got["b16"], obj["b16"])
    jgot = paddle.load(path)
    np.testing.assert_array_equal(to_np(jgot["w"]), obj["w"].numpy())
    raw = ptt.load(path, return_numpy=True)
    assert isinstance(raw["w"], np.ndarray)
    # the JAX package's save, read by the port
    jpath = str(tmp_path / "j.pdparams")
    paddle.save({"a": paddle.to_tensor(np.arange(4.0, dtype=np.float32))},
                jpath)
    assert ptt.load(jpath)["a"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_callbacks(tmp_path):
    x, y = _data(16)
    ds = TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    _, t = _nets()
    sched = topt.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    model = hapi.Model(t).prepare(
        topt.SGD(sched, parameters=t.parameters()), nn.CrossEntropyLoss())
    stop = hapi.EarlyStopping(monitor="loss", patience=0)
    stop.best = -1.0                   # nothing beats it: stop at once
    model.fit(ds, ds, batch_size=8, epochs=5, verbose=0,
              save_dir=str(tmp_path / "ck"),
              callbacks=[stop, hapi.LRScheduler(by_step=True)])
    assert stop.stopped and model.stop_training
    assert sorted(os.listdir(tmp_path / "ck")) == ["0.pdopt", "0.pdparams"]
    assert sched.last_lr == pytest.approx(0.1 * 0.5 ** 2)


def test_metrics_match_jax():
    r = np.random.default_rng(4)
    pred = r.standard_normal((10, 5)).astype(np.float32)
    lab = r.integers(0, 5, (10, 1)).astype(np.int64)
    for mk in (lambda M: M.Accuracy(), lambda M: M.Accuracy(topk=(1, 3))):
        jm_, tm_ = mk(jmetric), mk(metric)
        for half in (slice(0, 6), slice(6, 10)):
            jr = jm_.update(jm_.compute(paddle.to_tensor(pred[half]),
                                        paddle.to_tensor(lab[half])))
            tr = tm_.update(tm_.compute(torch.from_numpy(pred[half]),
                                        torch.from_numpy(lab[half])))
            assert tr == jr
        assert tm_.accumulate() == jm_.accumulate()
        assert tm_.name() == jm_.name()
    probs = r.uniform(0, 1, (50,)).astype(np.float32)
    labels = (r.uniform(0, 1, (50,)) < probs).astype(np.int64)
    for cls in ("Precision", "Recall", "Auc"):
        jm_, tm_ = getattr(jmetric, cls)(), getattr(metric, cls)()
        jm_.update(paddle.to_tensor(probs), paddle.to_tensor(labels))
        tm_.update(torch.from_numpy(probs), torch.from_numpy(labels))
        assert tm_.accumulate() == pytest.approx(jm_.accumulate(),
                                                 rel=1e-12)
        tm_.reset()
        assert tm_.accumulate() == 0.0
    for k in (1, 2):
        assert float(metric.accuracy(torch.from_numpy(pred),
                                     torch.from_numpy(lab), k=k)) == \
            pytest.approx(float(to_np(jmetric.accuracy(
                paddle.to_tensor(pred), paddle.to_tensor(lab), k=k))))


def test_new_modules_import_no_jax():
    code = ("import json, sys, paddle_tpu_torch as p; "
            "import paddle_tpu_torch.vision, paddle_tpu_torch.hapi, "
            "paddle_tpu_torch.metric, paddle_tpu_torch.nn.utils; "
            "from paddle_tpu_torch.nn.layer import rnn, tail; "
            "from paddle_tpu_torch.nn.functional import tail as ft; "
            "from paddle_tpu_torch.framework import io; "
            "from paddle_tpu_torch.vision import ops, datasets, transforms; "
            "p.Model, p.summary, p.save, p.load, p.rnn_sequence; "
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'"
            ")))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
