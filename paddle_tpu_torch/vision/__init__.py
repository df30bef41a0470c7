"""``paddle.vision``: the counterpart of ``paddle_tpu/vision/`` — the
model zoo (``models``), ``datasets``, ``transforms`` and the detection
ops (``ops``)."""

from . import datasets, models, ops, transforms  # noqa: F401


def set_image_backend(backend):
    pass


def get_image_backend():
    return "numpy"


def image_load(path, backend=None):
    """The image at `path`: a PIL image (a numpy array with
    backend="cv2")."""
    if backend == "cv2":
        import cv2
        import numpy as _np
        return _np.asarray(cv2.imread(path))
    from PIL import Image
    return Image.open(path)
