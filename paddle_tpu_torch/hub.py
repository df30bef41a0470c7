"""paddle.hub: the counterpart of ``paddle_tpu/hub.py`` (ref:
python/paddle/hub.py). There is no network: only local repository
directories (a ``hubconf.py`` in each) load, and
``load_state_dict_from_url`` resolves only ``file://`` URLs and local
paths."""

import importlib.util
import os


def _load_hubconf(repo_dir):
    path = os.path.join(repo_dir, "hubconf.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no hubconf.py in {repo_dir}")
    spec = importlib.util.spec_from_file_location("hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def list(repo_dir, source="local", force_reload=False):  # noqa: A001
    if source != "local":
        raise RuntimeError("no network egress: only source='local' works")
    mod = _load_hubconf(repo_dir)
    return [n for n in dir(mod) if callable(getattr(mod, n))
            and not n.startswith("_")]


def help(repo_dir, model, source="local", force_reload=False):  # noqa: A001
    return getattr(_load_hubconf(repo_dir), model).__doc__


def load(repo_dir, model, *args, source="local", force_reload=False, **kw):
    if source != "local":
        raise RuntimeError("no network egress: only source='local' works")
    return getattr(_load_hubconf(repo_dir), model)(*args, **kw)


_HUB_DIR = None


def get_dir():
    """The hub cache directory: PADDLE_TPU_HUB_DIR, else
    ~/.cache/paddle_tpu_torch/hub (set_dir overrides both)."""
    global _HUB_DIR
    if _HUB_DIR is None:
        _HUB_DIR = os.environ.get(
            "PADDLE_TPU_HUB_DIR",
            os.path.join(os.path.expanduser("~"), ".cache",
                         "paddle_tpu_torch", "hub"))
    return _HUB_DIR


def set_dir(d):
    global _HUB_DIR
    _HUB_DIR = d


def load_state_dict_from_url(url, model_dir=None, check_hash=False,
                             file_name=None, method="get"):
    """Resolve only file:// URLs and local paths, or the file's name under
    model_dir (default: the hub directory); load it with the port's
    ``load`` (the JAX package's pickle format)."""
    path = url[len("file://"):] if url.startswith("file://") else url
    if not os.path.exists(path):
        cand = os.path.join(model_dir or get_dir(), file_name
                            or os.path.basename(path))
        if not os.path.exists(cand):
            raise RuntimeError(
                f"no network egress: {url} not found locally (searched "
                f"{path} and {cand}); place the weights file there")
        path = cand
    from .framework.io import load as _load
    return _load(path)
