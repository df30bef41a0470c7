"""``paddle.hapi``: the counterpart of ``paddle_tpu/hapi/__init__.py`` —
the callbacks (``Callback``, ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping``, ``LRScheduler``; :17-126), ``Model`` (:128: ``prepare``,
``train_batch``, ``eval_batch``, ``predict_batch``, ``fit`` :191,
``evaluate`` :243, ``predict`` :263, ``save`` / ``load`` :276-288,
``summary``) and ``summary`` (:297).

``Model`` trains through ``jit.compile_train_step`` (forward, backward,
the optimizer's update) and reads its data through ``io.DataLoader``,
whose batches land on the current device. As the JAX ``fit`` does, each
training step with metrics is followed by a forward of the same batch in
eval mode, without gradients, for the metrics (:215-219): BatchNorm then
normalizes with its running statistics, and the step's outputs are not
reused. ``save`` writes ``path.pdparams`` (the network's state dict:
parameters and persistable buffers) and ``path.pdopt`` (the optimizer's)
through ``framework.io.save``, in the JAX package's format; the JAX
``save`` first copies the optimizer state out of its compiled step
(``sync_optimizer_state``), where the port's step updates the
optimizer's own state in place.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..framework.io import load as _load
from ..framework.io import save as _save
from ..io import DataLoader


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


class Callback:
    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class ProgBarLogger(Callback):
    """Prints the step's logs every log_freq steps and each epoch's
    seconds (verbose 0: nothing)."""

    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                               else f"{k}: {v}"
                               for k, v in (logs or {}).items())
            print(f"Epoch {self.epoch} step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch} done in {time.time() - self.t0:.1f}s")


class ModelCheckpoint(Callback):
    """``model.save(save_dir/<epoch>)`` every save_freq epochs."""

    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir or "checkpoint"

    def on_epoch_end(self, epoch, logs=None):
        if epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))


class EarlyStopping(Callback):
    """Stops training once the monitored eval value has not improved for
    more than `patience` evaluations."""

    def __init__(self, monitor="loss", mode="min", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.best = None
        self.wait = 0
        self.stopped = False

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(np.asarray(cur).reshape(-1)[0])
        better = self.best is None or (
            cur < self.best if self.mode == "min" else cur > self.best)
        if better:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stopped = True
                self.model.stop_training = True


class LRScheduler(Callback):
    """Steps the optimizer's learning-rate scheduler after each batch
    (by_step) or each epoch (by_epoch)."""

    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        return getattr(self.model._optimizer, "_lr_scheduler", None)

    def on_train_batch_end(self, step, logs=None):
        if self.by_step and self._sched() is not None:
            self._sched().step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch and self._sched() is not None:
            self._sched().step()


def _listed(v):
    return v if isinstance(v, (list, tuple)) else [v]


class Model:
    """A network with its optimizer, loss and metrics (``prepare``), and
    the loops over data: ``fit``, ``evaluate``, ``predict``."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._step_fn = None
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = list(metrics) if isinstance(metrics, (list, tuple)) \
            else ([metrics] if metrics else [])
        return self

    def _build_step(self):
        from ..jit import compile_train_step

        def loss_fn(model, *batch):
            *xs, y = batch
            return self._loss(model(*xs), y)

        self._step_fn = compile_train_step(self.network, loss_fn,
                                           self._optimizer)

    def train_batch(self, inputs, labels=None):
        """One optimizer step on the batch: [loss as a numpy array]."""
        if self._step_fn is None:
            self._build_step()
        loss = self._step_fn(*_listed(inputs), *_listed(labels))
        return [_np(loss)]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        """([loss], outputs) of an eval-mode forward."""
        self.network.eval()
        out = self.network(*_listed(inputs))
        loss = self._loss(out, *_listed(labels))
        self.network.train()
        return [_np(loss)], out

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        out = self.network(*_listed(inputs))
        self.network.train()
        return [_np(out)]

    def _as_loader(self, data, batch_size, shuffle):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """Train for `epochs` (at most num_iters steps in all), with an
        evaluation every eval_freq epochs; returns {"loss": [per step]}."""
        train_loader = self._as_loader(train_data, batch_size, shuffle)
        eval_loader = self._as_loader(eval_data, batch_size, False)
        cbs = [ProgBarLogger(log_freq, verbose)] + list(callbacks or [])
        if save_dir:
            cbs.append(ModelCheckpoint(save_freq, save_dir))
        for cb in cbs:
            cb.set_model(self)
        self.stop_training = False
        history = {"loss": []}
        for cb in cbs:
            cb.on_train_begin()
        it = 0
        for epoch in range(epochs):
            for cb in cbs:
                cb.on_epoch_begin(epoch)
            for step, batch in enumerate(train_loader):
                *xs, y = _listed(batch)
                loss = self.train_batch(xs, [y])[0]
                logs = {"loss": float(np.asarray(loss).reshape(-1)[0])}
                if self._metrics:
                    with torch.no_grad():
                        self.network.eval()
                        out = self.network(*xs)
                        self.network.train()
                    for m in self._metrics:
                        res = m.update(m.compute(out, y))
                        name = m.name()
                        logs[name if isinstance(name, str) else name[0]] = res
                history["loss"].append(logs["loss"])
                for cb in cbs:
                    cb.on_train_batch_end(step, logs)
                it += 1
                if num_iters is not None and it >= num_iters:
                    self.stop_training = True
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                for cb in cbs:
                    cb.on_eval_end(eval_logs)
            for cb in cbs:
                cb.on_epoch_end(epoch, {})
            if self.stop_training:
                break
        for cb in cbs:
            cb.on_train_end()
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        """{"loss": [mean of the batches' losses], metric name: its
        accumulated value} (a multi-k Accuracy under its first name, its
        value the list)."""
        loader = self._as_loader(eval_data, batch_size, False)
        losses = []
        for m in self._metrics:
            m.reset()
        for batch in loader:
            *xs, y = _listed(batch)
            (loss,), out = self.eval_batch(xs, [y])
            losses.append(float(np.asarray(loss).reshape(-1)[0]))
            for m in self._metrics:
                m.update(m.compute(out, y))
        result = {"loss": [float(np.mean(losses))] if losses else [0.0]}
        for m in self._metrics:
            name = m.name()
            result[name if isinstance(name, str) else name[0]] = \
                m.accumulate()
        return result

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """[[per-batch outputs]] (numpy), or [all outputs stacked]; a
        batch's last field (its label) is not fed."""
        loader = self._as_loader(test_data, batch_size, False)
        outs = []
        for batch in loader:
            xs = _listed(batch)
            if len(xs) > 1:
                xs = xs[:-1]
            outs.append(self.predict_batch(xs)[0])
        if stack_outputs:
            return [np.concatenate(outs, axis=0)]
        return [outs]

    def save(self, path, training=True):
        """path.pdparams, and path.pdopt when training and there is an
        optimizer."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        self.network.set_state_dict(_load(path + ".pdparams"))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(_load(path + ".pdopt"))

    def parameters(self, *a, **kw):
        return self.network.parameters(*a, **kw)

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)


def summary(net, input_size=None, dtypes=None, input=None):  # noqa: A002
    """Prints a table of the parameters (name, shape, count) and the
    totals; returns {"total_params", "trainable_params"}."""
    rows = []
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = p.numel()
        total += n
        if getattr(p, "trainable", p.requires_grad):
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max([len(r[0]) for r in rows], default=20) + 2
    lines = [f"{'Layer (param)':<{width}}{'Shape':<20}{'Params':>12}"]
    lines += [f"{r[0]:<{width}}{str(r[1]):<20}{r[2]:>12,}" for r in rows]
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}

