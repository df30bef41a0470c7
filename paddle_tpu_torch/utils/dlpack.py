"""DLPack interop (ref: python/paddle/utils/dlpack.py): the counterpart of
``paddle_tpu/utils/dlpack.py``, over ``torch.utils.dlpack``.

``to_dlpack`` gives a DLPack capsule of a tensor (sharing its memory);
``from_dlpack`` takes a capsule or any object of the ``__dlpack__``
protocol (a JAX array, a numpy array, a CuPy array) and returns a
``torch.Tensor`` over the same memory."""

from torch.utils import dlpack as _dlpack


def to_dlpack(x):
    return _dlpack.to_dlpack(x)


def from_dlpack(ext_array):
    return _dlpack.from_dlpack(ext_array)
