"""``paddle.version``: the counterpart of ``paddle_tpu/version.py``, with
the same version fields. The build facts describe the port: it runs on
CUDA, and ``cuda()`` names the CUDA version of the installed PyTorch."""

full_version = "0.1.0"
major = "0"
minor = "1"
patch = "0"
rc = "0"
commit = "torch-cuda"
with_custom_device = True
cuda_version = "False"
cudnn_version = "False"


def show():
    import torch
    print(f"paddle_tpu_torch {full_version} (PyTorch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")


def cuda():
    """The CUDA version the installed PyTorch was built with, or False."""
    import torch
    return torch.version.cuda or False


def xpu():
    return False
