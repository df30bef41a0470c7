"""Devices: the counterpart of ``paddle_tpu/device/__init__.py``.

The port runs on the CUDA card unless the caller asks for the CPU. The
current device (``set_device``) is where creation ops put a new tensor
and what ``resolve_device(None)`` returns: CUDA, until
``set_device("cpu")`` (or a ``device=``/``place=`` argument) says
otherwise. With no CUDA device and no CPU request, ``resolve_device`` and
``set_device("gpu")`` raise: a run never drops to the CPU silently
(unlike the JAX package's ``set_device``, which maps ``"gpu"`` to
whatever device JAX has).

Places (``CPUPlace``, ``CUDAPlace``) name a ``torch.device``. The
``cuda`` namespace reads the card's memory statistics through
``torch.cuda``; ``Stream`` and ``Event`` are ``torch.cuda.Stream`` /
``torch.cuda.Event`` on the card and markers on the CPU, as the JAX
package's are on the TPU.
"""

from __future__ import annotations

import time

import torch

_CURRENT = [None]       # a torch.device; None: the CUDA card


class Place:
    """A place: one ``torch.device``."""

    def __init__(self, device):
        self._device = torch.device(device)

    @property
    def dev_type(self):
        return "gpu" if self._device.type == "cuda" else self._device.type

    def get_device_id(self):
        return self._device.index or 0

    def __repr__(self):
        if self._device.type == "cpu":
            return "Place(cpu)"
        return f"Place(gpu:{self.get_device_id()})"

    def __eq__(self, other):
        return isinstance(other, Place) and self._device == other._device

    def __hash__(self):
        return hash(self._device)

    def is_gpu_place(self):
        return self._device.type == "cuda"

    def is_cpu_place(self):
        return self._device.type == "cpu"

    def is_custom_place(self):
        return False


class CPUPlace(Place):
    def __init__(self):
        super().__init__("cpu")


class CUDAPlace(Place):
    def __init__(self, idx=0):
        super().__init__(torch.device("cuda", int(idx)))


class CustomPlace(Place):
    """A custom device's place (``paddle_tpu/device/__init__.py:57``):
    the accelerator, which is the CUDA card here, as the JAX package's is
    its TPU; `dev_type` is kept."""

    def __init__(self, dev_type="gpu", idx=0):
        super().__init__(torch.device("cuda", int(idx)))
        self.custom_type = dev_type

    def is_custom_place(self):
        return True


def _parse(device):
    """A device spec (None, a Place, a torch.device, "cpu", "gpu",
    "gpu:N", "cuda", "cuda:N") as a torch.device; None stays None."""
    if device is None or isinstance(device, torch.device):
        return device
    if isinstance(device, Place):
        return device._device
    if isinstance(device, int):
        return torch.device("cuda", device)
    name = str(device).lower()
    plat, _, idx = name.partition(":")
    if plat in ("gpu", "cuda"):
        return torch.device("cuda", int(idx)) if idx else \
            torch.device("cuda")
    if plat == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unsupported device {device!r}: the port runs on "
                     "'gpu[:N]' (CUDA) or 'cpu'")


def _require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or set_device('cpu')) to run the "
            "plain PyTorch path")


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` of `device`; None means the current device
    (``set_device``; the CUDA card unless the CPU was asked for). Raises
    RuntimeError when CUDA is asked for (explicitly or by default) and no
    CUDA device is present."""
    dev = _parse(device)
    if dev is None:
        dev = _CURRENT[0] if _CURRENT[0] is not None else \
            torch.device("cuda")
    if dev.type == "cuda":
        _require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_device(device):
    """Make `device` ("cpu", "gpu", "gpu:N", a Place) the current device
    and return its Place. "gpu" with no CUDA device raises."""
    dev = _parse(device)
    if dev is None:
        raise ValueError("set_device needs a device")
    dev = resolve_device(dev)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    _CURRENT[0] = dev
    return Place(dev)


def get_device():
    """The current device as "gpu:N" or "cpu" ("cpu" when nothing was set
    and no CUDA device is present)."""
    dev = _CURRENT[0]
    if dev is None:
        if not torch.cuda.is_available():
            return "cpu"
        return f"gpu:{torch.cuda.current_device()}"
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"


def get_all_device_type():
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def get_available_device():
    return ["cpu"] + [f"gpu:{i}" for i in range(torch.cuda.device_count())]


def device_count():
    return torch.cuda.device_count()


def is_compiled_with_cuda():
    return torch.backends.cuda.is_built()


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_xpu():
    return False


def is_compiled_with_custom_device(dev_type="gpu"):
    return False


def is_compiled_with_distribute():
    return torch.distributed.is_available()


def is_compiled_with_cinn():
    return False


def is_compiled_with_ipu():
    return False


def get_cudnn_version():
    return torch.backends.cudnn.version() if torch.cuda.is_available() \
        else None


def get_all_custom_device_type():
    return []


def get_available_custom_device():
    return []


def synchronize(device=None):
    """Wait for the work queued on the card (nothing to wait for on the
    CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cuda_dev(device):
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"device.cuda reads a CUDA device, not {dev}")
    return dev


class cuda:
    """``paddle.device.cuda``: the card's memory statistics and helpers,
    over ``torch.cuda``."""

    @staticmethod
    def max_memory_allocated(device=None):
        return torch.cuda.max_memory_allocated(_cuda_dev(device))

    @staticmethod
    def memory_allocated(device=None):
        return torch.cuda.memory_allocated(_cuda_dev(device))

    @staticmethod
    def max_memory_reserved(device=None):
        return torch.cuda.max_memory_reserved(_cuda_dev(device))

    @staticmethod
    def memory_reserved(device=None):
        return torch.cuda.memory_reserved(_cuda_dev(device))

    @staticmethod
    def device_count():
        return torch.cuda.device_count()

    @staticmethod
    def synchronize(device=None):
        synchronize(device)

    @staticmethod
    def empty_cache():
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    @staticmethod
    def get_device_properties(device=None):
        return torch.cuda.get_device_properties(_cuda_dev(device))


class Stream:
    """A ``torch.cuda.Stream`` on the card; on the CPU a marker (work runs
    in order, so there is nothing to wait for)."""

    def __init__(self, device=None, priority=2, *, _stream=None):
        self.device = resolve_device(device)
        self.priority = priority
        if _stream is not None:
            self._s = _stream
        elif self.device.type == "cuda":
            # paddle's priority 1 is high, 2 normal; torch's -1 is high
            self._s = torch.cuda.Stream(self.device,
                                        priority=-1 if priority == 1 else 0)
        else:
            self._s = None

    @property
    def cuda_stream(self):
        return self._s

    def synchronize(self):
        if self._s is not None:
            self._s.synchronize()

    def wait_event(self, event):
        if self._s is not None and event._e is not None:
            self._s.wait_event(event._e)

    def wait_stream(self, stream):
        if self._s is not None and stream._s is not None:
            self._s.wait_stream(stream._s)

    def record_event(self, event=None):
        event = event or Event(self.device)
        event.record(self)
        return event

    def query(self):
        return True if self._s is None else self._s.query()


class Event:
    """A ``torch.cuda.Event`` on the card (``elapsed_time`` in ms needs
    enable_timing); on the CPU a marker holding the host clock."""

    def __init__(self, device=None, enable_timing=False, blocking=False,
                 interprocess=False):
        dev = resolve_device(device)
        self._t = None
        self._e = torch.cuda.Event(enable_timing=enable_timing,
                                   blocking=blocking,
                                   interprocess=interprocess) \
            if dev.type == "cuda" else None

    def record(self, stream=None):
        if self._e is None:
            self._t = time.perf_counter()
        else:
            self._e.record(None if stream is None else stream._s)

    def synchronize(self):
        if self._e is not None:
            self._e.synchronize()

    def query(self):
        return True if self._e is None else self._e.query()

    def elapsed_time(self, end):
        """Milliseconds from this event to `end`."""
        if self._e is None:
            return (end._t - self._t) * 1e3
        return self._e.elapsed_time(end._e)


_STREAMS = {}           # device -> the Stream set by set_stream


def current_stream(device=None):
    """The stream work on `device` goes to: the one ``set_stream`` or
    ``stream_guard`` made current, else the device's current stream."""
    dev = resolve_device(device)
    if dev in _STREAMS:
        return _STREAMS[dev]
    if dev.type == "cuda":
        return Stream(dev, _stream=torch.cuda.current_stream(dev))
    return Stream(dev)


def set_stream(stream):
    """Make `stream` current on its device; returns the previous one."""
    prev = current_stream(stream.device)
    _STREAMS[stream.device] = stream
    if stream._s is not None:
        torch.cuda.set_stream(stream._s)
    return prev


class stream_guard:
    """``with stream_guard(s):`` runs the block's work on `s`."""

    def __init__(self, stream):
        self.stream = stream

    def __enter__(self):
        self._prev = set_stream(self.stream)
        return self.stream

    def __exit__(self, *exc):
        set_stream(self._prev)
        if self._prev.device in _STREAMS and \
                _STREAMS[self._prev.device] is self._prev:
            del _STREAMS[self._prev.device]
        return False


__all__ = ["CPUPlace", "CUDAPlace", "Event", "Place", "Stream", "cuda",
           "current_stream", "device_count", "get_all_custom_device_type",
           "get_all_device_type", "get_available_custom_device",
           "get_available_device", "get_cudnn_version", "get_device",
           "is_compiled_with_cinn", "is_compiled_with_cuda",
           "is_compiled_with_custom_device", "is_compiled_with_distribute",
           "is_compiled_with_ipu", "is_compiled_with_rocm",
           "is_compiled_with_xpu", "resolve_device", "set_device",
           "set_stream", "stream_guard", "synchronize"]
