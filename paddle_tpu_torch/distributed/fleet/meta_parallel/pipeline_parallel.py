"""Pipeline runtime: the counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``
(``PipelineParallel`` :25 with its 1F1B ``forward_backward_pipeline`` :70,
``train_batch`` :118, ``eval_batch`` :131;
``PipelineParallelWithInterleave`` :143; ``TensorParallel`` and
``SegmentParallel`` :225).

Single controller, as in the JAX package: the schedule issues
micro-batch forwards and backwards in the 1F1B order (min(S, M) warm-up
forwards, then one backward and one forward, then the cool-down
backwards), each forward through every chunk of the ``PipelineLayer``
(its stages on their devices, the activations crossing by counted
transfers). Each micro-batch's loss is divided by the micro-batch count
before its backward, which frees that micro-batch's graph, so at most
min(S, M) graphs are alive; the parameters' gradients accumulate across
micro-batches. The interleaved runtime issues work in
``pipeline_schedules.interleaved_1f1b``'s order and retires a
micro-batch's backward where the schedule retires its chunk-0 backward.
"""

from __future__ import annotations

import torch

from ....nn.layers import Layer
from ...fleet.base.topology import get_hcg


class _Wrapper(Layer):
    """A wrapper that keeps the wrapped model's surface: its parameters,
    state dict and names (no ``_layers.`` prefix), as the JAX wrappers
    delegate them."""

    def __init__(self, layers):
        super().__init__()
        self._layers = layers

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        return self._layers.load_state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        return self._layers.set_state_dict(*args, **kwargs)


def _gather_params(optimizer):
    """ZeRO stage 3: the parameters back from their owners before use."""
    zero = getattr(optimizer, "_zero", None)
    if zero is not None:
        zero.gather_params()


class PipelineParallel(_Wrapper):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__(layers)
        from .pp_layers import PipelineLayer
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        self._hcg = hcg or get_hcg()
        self._strategy = strategy
        acc = 1
        if strategy is not None:
            try:
                acc = strategy.pipeline_configs.get("accumulate_steps", 1)
            except AttributeError:
                acc = getattr(strategy, "accumulate_steps", 1) or 1
        self._acc_steps = max(int(acc), 1)
        self.num_stages = layers._num_stages

    def forward(self, x):
        return self._layers(x)

    def _split_micro(self, data):
        n = self._acc_steps
        if isinstance(data, (tuple, list)):
            parts = [self._split_micro(d) for d in data]
            return list(zip(*parts))
        b = data.shape[0]
        if b % n != 0:
            raise ValueError(
                f"batch size {b} must be divisible by accumulate_steps {n}")
        mb = b // n
        return [data[i * mb:(i + 1) * mb] for i in range(n)]

    def _loss(self, x, label):
        return self._layers._loss_fn(x, label.to(x.device))

    def _backward(self, loss, n_micro, scaler):
        l = loss / n_micro
        if scaler is not None:
            l = scaler.scale(l)
        l.backward()

    @staticmethod
    def _mean(losses, n_micro):
        total = losses[0].detach()
        for l in losses[1:]:
            total = total + l.detach().to(total.device)
        return total / n_micro

    def forward_backward_pipeline(self, data, scaler=None):
        """1F1B over the micro-batches of data = (inputs, labels); returns
        the mean loss (detached)."""
        micro_inputs, micro_labels = data
        micro_in = self._split_micro(micro_inputs)
        micro_lb = self._split_micro(micro_labels)
        n_micro = len(micro_in)
        losses = []

        def fwd_full(k):
            x = micro_in[k]
            for c in range(len(self._layers._chunk_bounds)):
                x = self._layers.forward_chunk(x, c)
            losses.append(self._loss(x, micro_lb[k]))

        warmup = min(self.num_stages, n_micro)
        for k in range(warmup):
            fwd_full(k)
        done_b = 0
        for k in range(warmup, n_micro):
            self._backward(losses[done_b], n_micro, scaler)
            done_b += 1
            fwd_full(k)
        while done_b < n_micro:
            self._backward(losses[done_b], n_micro, scaler)
            done_b += 1
        return self._mean(losses, n_micro)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """``pipeline_parallel.py:118``: the pipeline's forward and backward,
        then the (scaled) step, the gradients cleared and the scheduler
        stepped. Returns the mean loss."""
        _gather_params(optimizer)
        loss = self.forward_backward_pipeline(data, scaler)
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def eval_batch(self, data, compute_loss=True):
        micro_inputs, micro_labels = data
        with torch.no_grad():
            x = micro_inputs
            for c in range(len(self._layers._chunk_bounds)):
                x = self._layers.forward_chunk(x, c)
            if compute_loss:
                return self._loss(x, micro_labels)
            return x


class PipelineParallelWithInterleave(PipelineParallel):
    """Interleaved virtual pipeline (``pipeline_parallel.py:143``): S*V
    chunks, chunk c on stage c % S; the issue order follows
    ``interleaved_1f1b``, and a micro-batch's backward runs whole where the
    schedule retires its chunk-0 backward."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__(layers, hcg, strategy)
        if getattr(layers, "_num_virtual", 1) < 2:
            raise ValueError(
                "PipelineParallelWithInterleave needs a PipelineLayer built "
                "with num_virtual_pipeline_stages >= 2")
        self.num_virtual = layers._num_virtual

    def forward_backward_pipeline(self, data, scaler=None):
        from .pipeline_schedules import interleaved_1f1b

        micro_inputs, micro_labels = data
        micro_in = self._split_micro(micro_inputs)
        micro_lb = self._split_micro(micro_labels)
        n_micro = len(micro_in)
        S, V = self.num_stages, self.num_virtual

        sched0 = interleaved_1f1b(n_micro, S, V)[0]
        state = dict(enumerate(micro_in))
        losses = {}
        for kind, k, v in sched0:
            if kind == "F":
                x = state[k]
                for s in range(S):
                    x = self._layers.forward_chunk(x, v * S + s)
                state[k] = x
                if v == V - 1:
                    losses[k] = self._loss(x, micro_lb[k])
                    state[k] = None       # the loss holds the graph
            elif v == 0:
                if k not in losses:
                    raise RuntimeError("schedule issued B before F "
                                       "completed")
                self._backward(losses[k], n_micro, scaler)
        return self._mean([losses[k] for k in range(n_micro)], n_micro)


class TensorParallel(_Wrapper):
    """``fleet/meta_parallel/tensor_parallel.py``: the model as it is (the
    mpu layers compute rank by rank; the mp group's inputs are one
    process's tensors already)."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__(layers)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)


class SegmentParallel(_Wrapper):
    """``fleet/meta_parallel/segment_parallel.py``: the sequence dim as an
    axis of its own; the model runs as it is, its inputs laid out over
    sep by the caller (``sequence_parallel_utils``)."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__(layers)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)
