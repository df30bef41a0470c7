"""The port's ``device`` package on the CPU: the current-device rule
(creation ops and ``resolve_device(None)`` follow ``set_device``; with no
card and no CPU request they raise, and ``set_device("gpu")`` raises
where the JAX package's maps "gpu" to whatever device JAX has), places,
``synchronize``, the ``cuda`` namespace, and ``Stream`` / ``Event`` as
markers on the CPU. The card's side (``max_memory_allocated`` against
``torch.cuda``'s, events on a side stream) runs in ``chip_smoke.py``'s
``[device]`` phase.
"""

import time

import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import device as tdevice
from torch_parity import cpu_device  # noqa: F401

NO_CARD = not torch.cuda.is_available()


@pytest.mark.skipif(not NO_CARD, reason="checks the no-card rule")
def test_no_card_and_no_cpu_request_raises():
    tdevice._CURRENT[0] = None
    for fn in (lambda: ptt.zeros([2]), lambda: ptt.to_tensor([1.0]),
               lambda: ptt.rand([2]), lambda: ptt.set_device("gpu"),
               lambda: ptt.set_device("gpu:0"), lambda: ptt.resolve_device(),
               lambda: ptt.arange(3), lambda: ptt.CUDAPlace(0) and
               ptt.zeros([1], device=ptt.CUDAPlace(0))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    assert ptt.get_device() == "cpu"


def test_set_device_round_trip_and_places():
    assert ptt.set_device("cpu") == ptt.CPUPlace()
    assert ptt.get_device() == "cpu"
    assert ptt.resolve_device() == torch.device("cpu")
    assert ptt.ones([2]).device.type == "cpu"
    assert ptt.to_tensor([1]).device.type == "cpu"
    # an op over an existing tensor runs where the tensor is
    assert ptt.add(torch.ones(2), 1.0).device.type == "cpu"
    p = ptt.CPUPlace()
    assert p.is_cpu_place() and not p.is_gpu_place() and p.dev_type == "cpu"
    g = ptt.CUDAPlace(1)
    assert g.is_gpu_place() and g.get_device_id() == 1
    assert repr(g) == "Place(gpu:1)" and repr(p) == "Place(cpu)"
    assert ptt.set_device(ptt.CPUPlace()).is_cpu_place()
    with pytest.raises(ValueError):
        ptt.set_device("tpu")
    assert ptt.device.device_count() == torch.cuda.device_count()
    assert ptt.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    assert "cpu" in ptt.device.get_all_device_type()
    assert ptt.device.get_available_device()[0] == "cpu"
    ptt.device.synchronize("cpu")


def test_streams_and_events_are_markers_on_the_cpu():
    s = ptt.device.Stream()
    assert s.cuda_stream is None and s.query()
    s.synchronize()
    e0, e1 = ptt.device.Event(), ptt.device.Event()
    e0.record(s)
    time.sleep(0.002)
    s.record_event(e1)
    assert e0.query() and e1.elapsed_time(e1) == 0.0
    assert e0.elapsed_time(e1) >= 1.0
    s.wait_event(e0)
    s.wait_stream(ptt.device.current_stream())
    with ptt.device.stream_guard(s) as cur:
        assert cur is s and ptt.device.current_stream() is s
    assert ptt.device.current_stream() is not s


def test_cuda_namespace_reads_torch_cuda():
    if NO_CARD:
        with pytest.raises(ValueError):
            ptt.device.cuda.max_memory_allocated("cpu")
        assert ptt.device.cuda.device_count() == 0
        ptt.device.cuda.empty_cache()
    else:
        assert ptt.device.cuda.max_memory_allocated(0) == \
            torch.cuda.max_memory_allocated(0)
