"""``paddle.inference`` in the port: the deploy predictor over a
``jit.save`` artifact, and serving (the paged continuous-batching engine
and its speculative decoding drafters).

The counterpart of ``paddle_tpu/inference/__init__.py``. The artifact is
``<path>.pt2`` (``torch.export`` of the eval forward, each kernel one
``ptt`` op node) beside the ``<path>.pdiparams`` weights; ``Config`` /
``create_predictor`` / ``Predictor`` keep the reference's calling
convention (``get_input_names``, ``copy_from_cpu``, ``run``,
``copy_to_cpu``), so serving code ports. ``Predictor.run`` replays the
exported graph eagerly on the card, through the same kernels as the
eager model; ``inference.native.NativePredictor`` runs the AOTInductor
compile of the same program, and ``inference.analysis`` holds the
program's analysis report and the dynamic batcher.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import (BlockManager, DeadlineExceededError, GenerationEngine,
                     GenRequest, RequestCancelledError,
                     make_sequence_snapshot)
from .speculative import (DraftModelDrafter, Drafter, NgramDrafter,
                          make_drafter, spec_decode_from_env)

__all__ = ["BlockManager", "Config", "DeadlineExceededError",
           "DraftModelDrafter", "Drafter", "GenerationEngine", "GenRequest",
           "NgramDrafter", "PlaceType", "PrecisionType", "Predictor",
           "RequestCancelledError", "create_predictor", "get_version",
           "make_drafter", "make_sequence_snapshot", "spec_decode_from_env"]


class PrecisionType:
    Float32 = "float32"
    Bfloat16 = "bfloat16"
    Half = "float16"
    Int8 = "int8"


class PlaceType:
    CPU = "cpu"
    GPU = "gpu"
    TPU = "tpu"
    CUSTOM = "custom"


def _strip(prog_file):
    if prog_file and prog_file.endswith(".pt2"):
        return prog_file[: -len(".pt2")]
    return prog_file


class Config:
    """ref: analysis_config.cc surface. The model is the jit.save path
    (a trailing ``.pt2`` is stripped); the device is the current one (the
    card unless the CPU was asked for: ``set_device``) until
    ``disable_gpu()`` selects the CPU or ``enable_use_gpu(device_id=)``
    the card ``cuda:<device_id>``."""

    def __init__(self, prog_file=None, params_file=None):
        self._model_path = _strip(prog_file)
        self._device = None
        self._precision = PrecisionType.Float32
        self._enable_memory_optim = True

    def set_model(self, prog_file, params_file=None):
        self._model_path = _strip(prog_file)

    def model_dir(self):
        return self._model_path

    def device(self):
        """The torch.device the predictor runs on."""
        from ..device import resolve_device
        return resolve_device(self._device)

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision=PrecisionType.Float32):
        self._device = f"cuda:{int(device_id)}"
        self._precision = precision

    def enable_custom_device(self, device_type="gpu", device_id=0):
        self._device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self):
        return self.device().type == "cuda"

    def enable_memory_optim(self, flag=True):
        self._enable_memory_optim = flag

    def switch_ir_optim(self, flag=True):
        pass   # the exported program is what runs

    def enable_tensorrt_engine(self, *a, **kw):
        raise NotImplementedError(
            "TensorRT is not used: the saved program runs the port's own "
            "CUDA kernels as ptt ops, replayed by Predictor or compiled by "
            "AOTInductor (inference.native.NativePredictor)")

    def summary(self):
        return (f"Config(model={self._model_path}, device={self.device()}, "
                f"precision={self._precision})")


def _to_numpy(t):
    from ..framework.io import _pack
    return _pack(t) if isinstance(t, torch.Tensor) else np.asarray(t)


class _IOHandle:
    """Input/output tensor handle (ref: ZeroCopyTensor)."""

    def __init__(self, predictor, idx):
        self._predictor = predictor
        self._idx = idx

    def copy_from_cpu(self, arr):
        self._predictor._inputs[self._idx] = np.ascontiguousarray(arr)

    def reshape(self, shape):
        pass   # shapes come from the array in copy_from_cpu

    def copy_to_cpu(self):
        return np.asarray(self._predictor._outputs[self._idx])

    def shape(self):
        out = self._predictor._outputs
        if out and self._idx < len(out):
            return list(np.asarray(out[self._idx]).shape)
        return []


class Predictor:
    """ref: analysis_predictor.h:105 / ZeroCopyRun:215: the jit.load'ed
    program (``jit.TranslatedLayer``) on the config's device. Inputs are
    numpy arrays or tensors; outputs come back as numpy arrays (bfloat16
    as ``ml_dtypes``). The analysis report and the serving features
    (dynamic batching, async run) live in ``inference.analysis``."""

    def __init__(self, config: Config):
        from ..jit import load as jit_load
        self._config = config
        self._layer = jit_load(config.model_dir(), device=config.device())
        self._n_inputs = self._layer.n_inputs
        self._inputs = {}
        self._outputs = []
        self._pool = None

    def analysis(self):
        """Static program analysis (op histogram, constants, matmul
        FLOPs) of the saved program."""
        from .analysis import ProgramAnalysis
        return ProgramAnalysis(self._config.model_dir())

    def _predict(self, x):
        return _to_numpy(self._layer(x))

    def make_batcher(self, max_batch=8, buckets=(1, 2, 4, 8),
                     timeout_ms=2.0):
        """Dynamic batching over this predictor's program."""
        from .analysis import DynamicBatcher
        return DynamicBatcher(self._predict, max_batch=max_batch,
                              buckets=buckets, timeout_ms=timeout_ms)

    def run_async(self, inputs):
        """``run(inputs)`` on a worker thread; returns its future."""
        import concurrent.futures
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="predictor")
        return self._pool.submit(self.run, inputs)

    def get_input_names(self):
        return [f"input_{i}" for i in range(self._n_inputs)]

    def get_output_names(self):
        return [f"output_{i}" for i in range(max(len(self._outputs), 1))]

    def get_input_handle(self, name):
        idx = int(name.rsplit("_", 1)[-1]) if "_" in name else 0
        return _IOHandle(self, idx)

    def get_output_handle(self, name):
        idx = int(name.rsplit("_", 1)[-1]) if "_" in name else 0
        return _IOHandle(self, idx)

    def run(self, inputs=None):
        """ZeroCopyRun: run the program on `inputs` (returns the outputs)
        or on the handles' inputs (returns True)."""
        if inputs is not None:
            arrs = [a if isinstance(a, torch.Tensor) else np.asarray(a)
                    for a in inputs]
        else:
            arrs = [self._inputs[i] for i in sorted(self._inputs)]
        out = self._layer(*arrs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        self._outputs = [_to_numpy(o) for o in outs]
        if inputs is not None:
            return self._outputs
        return True


def create_predictor(config: Config):
    return Predictor(config)


def get_version():
    return f"paddle_tpu_torch (torch {torch.__version__})"
