"""The port's ``vision`` against the JAX package's, on the CPU:

- ``transforms``: every class and functional form gives the same array
  as the JAX one on the same image (HWC uint8 and CHW float32) under the
  same ``random.seed`` (both are numpy on the host: exactly);
- ``datasets``: ``Cifar10`` / ``Cifar100`` over archives in the standard
  format that the test writes, ``MNIST`` / ``FashionMNIST`` over idx
  files (gzipped and not), ``ImageFolder`` / ``DatasetFolder`` over
  ``.npy`` trees, ``Flowers`` (jpgs in a tgz and the two ``.mat`` files)
  and ``VOC2012`` (a VOC tar) give the JAX datasets' samples, and the
  synthetic stand-ins theirs; ``io.DataLoader`` over ``Cifar10`` batches
  them as the JAX loader does;
- ``ops``: ``nms`` (scores, categories, top_k), ``roi_align`` (aligned
  or not, sampling ratios), ``roi_pool``, ``box_coder`` (encode and
  decode, shared and per-prior variances), ``prior_box`` and
  ``deform_conv2d`` (v1, v2 with a mask, groups, deformable groups)
  against the JAX ops (float64 1e-10; the ops that compute in float32
  whatever their input, as the JAX ones do, 2e-5 relative and 1e-5
  absolute);
- ResNet: the parameter counts 25,557,032 (``resnet50()``) and 23,528,522
  (``resnet50(num_classes=10)``), equal to the JAX models'; ResNet-18 and
  ResNet-50 forwards in float64 (train and eval) with seeded weights
  carried from the JAX model into the port
  (``weights.from_paddle_tpu_state``, BatchNorm statistics included) and
  back (``torch_vision_parity.forward_parity``).
"""

import gzip
import io
import os
import pickle
import random
import struct
import tarfile
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.vision.ops as jops
from paddle_tpu.io import DataLoader as JDataLoader
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import models as jm
from paddle_tpu.vision import transforms as jT

import paddle_tpu_torch as ptt
from paddle_tpu_torch import weights
from paddle_tpu_torch.io import DataLoader
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import models as tm
from paddle_tpu_torch.vision import ops as tops
from paddle_tpu_torch.vision import transforms as tT
from torch_parity import assert_same, cpu_device, to_np  # noqa: F401
from torch_vision_parity import (fast_jax_init,  # noqa: F401
                                 forward_parity, names_and_shapes)

torch.set_num_threads(1)

R = np.random.default_rng(30)
HWC = R.integers(0, 256, (20, 24, 3), dtype=np.uint8)
CHW = R.uniform(0, 1, (3, 20, 24)).astype(np.float32)


def _same_draws(make, img, seed=7):
    random.seed(seed)
    want = make(jT)(img.copy())
    random.seed(seed)
    got = make(tT)(img.copy())
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype


TRANSFORMS = {
    "pipeline": lambda T: T.Compose([
        T.ToTensor(), T.Normalize([0.5] * 3, [0.5] * 3),
        T.RandomHorizontalFlip(0.5), T.RandomCrop(16, padding=2)]),
    "to_tensor_hwc": lambda T: T.ToTensor(),
    "normalize_hwc": lambda T: T.Normalize(0.4, 0.2, data_format="HWC"),
    "resize_short": lambda T: T.Resize(12),
    "resize_exact": lambda T: T.Resize((9, 31)),
    "random_crop_reflect": lambda T: T.RandomCrop(
        [18, 22], padding=[1, 2, 3, 4], padding_mode="reflect"),
    "random_crop_pad_needed": lambda T: T.RandomCrop(
        28, pad_if_needed=True, fill=3),
    "center_crop": lambda T: T.CenterCrop(10),
    "vflip": lambda T: T.RandomVerticalFlip(0.5),
    "random_resized_crop": lambda T: T.RandomResizedCrop(14),
    "transpose": lambda T: T.Transpose((1, 2, 0)),
    "brightness": lambda T: T.BrightnessTransform(0.4),
    "contrast": lambda T: T.ContrastTransform(0.4),
    "color_jitter": lambda T: T.ColorJitter(0.3, 0.3, 0.3, 0.1),
    "grayscale": lambda T: T.Grayscale(3),
    "hue": lambda T: T.HueTransform(0.2),
    "saturation": lambda T: T.SaturationTransform(0.5),
    "pad_symmetric": lambda T: T.Pad([1, 2], padding_mode="symmetric"),
    "rotation": lambda T: T.RandomRotation(30),
    "affine": lambda T: T.RandomAffine(20, translate=(0.1, 0.2),
                                       scale=(0.8, 1.2), shear=10),
    "perspective": lambda T: T.RandomPerspective(prob=1.0),
    "erasing": lambda T: T.RandomErasing(prob=1.0, value=5),
}


TRANSFORM_CASES = [(n, kind) for n in sorted(TRANSFORMS)
                   for kind in ("hwc_u8", "chw_f32")
                   if not (n.endswith("_hwc") and kind == "chw_f32")]


@pytest.mark.parametrize("name,kind", TRANSFORM_CASES,
                         ids=[f"{n}-{k}" for n, k in TRANSFORM_CASES])
def test_transform_matches_jax(name, kind):
    img = HWC if kind == "hwc_u8" else CHW
    for seed in (1, 2, 3):
        _same_draws(TRANSFORMS[name], img, seed)


FUNCTIONAL = [
    ("to_tensor", ()), ("normalize", ([0.2] * 3, [0.5] * 3)),
    ("resize", ((10, 7),)), ("hflip", ()), ("vflip", ()),
    ("adjust_brightness", (1.3,)), ("adjust_contrast", (0.7,)),
    ("adjust_hue", (0.1,)), ("adjust_saturation", (1.4,)),
    ("to_grayscale", (3,)), ("crop", (2, 3, 10, 12)),
    ("center_crop", (8,)), ("pad", ((1, 2, 3, 4), 7)),
    ("affine", (15.0, (2, -1), 1.1, (5.0, 0.0))), ("rotate", (40,)),
    ("perspective", ([[0, 0], [23, 0], [23, 19], [0, 19]],
                     [[2, 1], [21, 3], [20, 17], [1, 18]])),
    ("erase", (3, 4, 5, 6, 0)),
]


@pytest.mark.parametrize("name,args", FUNCTIONAL,
                         ids=[f[0] for f in FUNCTIONAL])
def test_functional_transform_matches_jax(name, args):
    for img in (HWC, CHW):
        if img is HWC and name in ("normalize", "resize", "hflip", "vflip"):
            continue                    # CHW forms only
        want = getattr(jT, name)(img.copy(), *args)
        got = getattr(tT, name)(img.copy(), *args)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_every_transform_name_is_on_the_port():
    public = {n for n in dir(jT) if not n.startswith("_")}
    assert public <= set(dir(tT)) and len(public) > 40


# -- datasets --

def _cifar_archive(path, n_train, n_test, labels_key=b"labels",
                   layout="cifar-10-batches-py", names=None, seed=0):
    r = np.random.default_rng(seed)
    names = names or [f"data_batch_{i}" for i in range(1, 6)] + \
        ["test_batch"]
    with tarfile.open(path, "w:gz") as tf:
        for name in names:
            n = n_test if "test" in name else n_train
            batch = {b"data": r.integers(0, 256, (n, 3072), dtype=np.uint8),
                     labels_key: r.integers(0, 10, n).tolist()}
            raw = pickle.dumps(batch)
            info = tarfile.TarInfo(f"{layout}/{name}")
            info.size = len(raw)
            tf.addfile(info, io.BytesIO(raw))


def _same_samples(tset, jset, n=None):
    assert len(tset) == len(jset)
    for i in range(min(len(jset), n or len(jset))):
        for a, b in zip(tset[i], jset[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cifar10_and_cifar100_archives(tmp_path):
    c10 = str(tmp_path / "cifar-10-python.tar.gz")
    _cifar_archive(c10, 6, 5)
    for mode in ("train", "test"):
        t = tds.Cifar10(data_file=c10, mode=mode,
                        transform=tT.Normalize([0.5] * 3, [0.2] * 3))
        j = jds.Cifar10(data_file=c10, mode=mode,
                        transform=jT.Normalize([0.5] * 3, [0.2] * 3))
        assert len(t) == (30 if mode == "train" else 5)
        _same_samples(t, j)
        img, lab = t[0]
        assert img.shape == (3, 32, 32) and lab.dtype == np.int64
    c100 = str(tmp_path / "cifar-100-python.tar.gz")
    _cifar_archive(c100, 7, 4, labels_key=b"fine_labels",
                   layout="cifar-100-python", names=["train", "test"])
    for mode in ("train", "test"):
        _same_samples(tds.Cifar100(data_file=c100, mode=mode),
                      jds.Cifar100(data_file=c100, mode=mode))
    with pytest.raises(FileNotFoundError):
        tds.Cifar10(data_file=str(tmp_path / "missing.tar.gz"))


def test_synthetic_and_fake_datasets():
    _same_samples(tds.FakeData(size=6, image_shape=(3, 8, 8)),
                  jds.FakeData(size=6, image_shape=(3, 8, 8)))
    _same_samples(tds.Cifar10(backend="synthetic", mode="test"),
                  jds.Cifar10(backend="synthetic", mode="test"), n=3)
    _same_samples(tds.MNIST(mode="test"), jds.MNIST(mode="test"), n=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same_samples(tds.Flowers(), jds.Flowers(), n=3)
        _same_samples(tds.VOC2012(), jds.VOC2012(), n=3)


def _idx(path, arr, gz):
    head = struct.pack(">I", 0x0800 | arr.ndim) + b"".join(
        struct.pack(">I", d) for d in arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_idx_files(tmp_path, gz):
    r = np.random.default_rng(1)
    ext = ".gz" if gz else ""
    img, lab = str(tmp_path / f"img{ext}"), str(tmp_path / f"lab{ext}")
    _idx(img, r.integers(0, 256, (5, 28, 28)), gz)
    _idx(lab, r.integers(0, 10, (5,)), gz)
    for cls in ("MNIST", "FashionMNIST"):
        t = getattr(tds, cls)(image_path=img, label_path=lab)
        _same_samples(t, getattr(jds, cls)(image_path=img, label_path=lab))
        assert t[0][0].shape == (1, 28, 28)


def test_image_folder_and_dataset_folder(tmp_path):
    r = np.random.default_rng(2)
    for c in ("cat", "dog"):
        os.makedirs(tmp_path / c)
        for i in range(3):
            np.save(tmp_path / c / f"{i}.npy",
                    r.standard_normal((3, 4, 4)).astype(np.float32))
    _same_samples(tds.DatasetFolder(str(tmp_path)),
                  jds.DatasetFolder(str(tmp_path)))
    t = tds.ImageFolder(str(tmp_path), transform=tT.Normalize(0.5, 2.0))
    _same_samples(t, jds.ImageFolder(str(tmp_path),
                                     transform=jT.Normalize(0.5, 2.0)))
    assert len(t) == 6


def _tar_add(tf, name, raw):
    info = tarfile.TarInfo(name)
    info.size = len(raw)
    tf.addfile(info, io.BytesIO(raw))


def _png(arr, fmt):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def test_flowers_and_voc_archives(tmp_path):
    from scipy.io import savemat
    r = np.random.default_rng(3)
    tgz = str(tmp_path / "102flowers.tgz")
    with tarfile.open(tgz, "w:gz") as tf:
        for i in range(1, 7):
            _tar_add(tf, f"jpg/image_{i:05d}.jpg", _png(
                r.integers(0, 256, (6, 5, 3), dtype=np.uint8), "JPEG"))
    labels, setid = str(tmp_path / "l.mat"), str(tmp_path / "s.mat")
    savemat(labels, {"labels": np.array([[3, 1, 4, 1, 5, 9]])})
    savemat(setid, {"trnid": np.array([[1, 2, 5]]),
                    "valid": np.array([[3]]), "tstid": np.array([[4, 6]])})
    for mode in ("train", "valid", "test"):
        _same_samples(tds.Flowers(tgz, labels, setid, mode=mode),
                      jds.Flowers(tgz, labels, setid, mode=mode))
    voc = str(tmp_path / "VOCtrainval.tar")
    root = "VOCdevkit/VOC2012"
    with tarfile.open(voc, "w") as tf:
        _tar_add(tf, f"{root}/ImageSets/Segmentation/train.txt",
                 b"a\nb\n")
        for i in ("a", "b"):
            _tar_add(tf, f"{root}/JPEGImages/{i}.jpg", _png(
                r.integers(0, 256, (6, 5, 3), dtype=np.uint8), "JPEG"))
            _tar_add(tf, f"{root}/SegmentationClass/{i}.png", _png(
                r.integers(0, 21, (6, 5), dtype=np.uint8), "PNG"))
    _same_samples(tds.VOC2012(voc), jds.VOC2012(voc))


def test_dataloader_batches_cifar10_as_jax(tmp_path):
    c10 = str(tmp_path / "cifar-10-python.tar.gz")
    _cifar_archive(c10, 4, 2, seed=4)
    np.random.seed(0)
    jb = list(JDataLoader(jds.Cifar10(data_file=c10), batch_size=8,
                          shuffle=True))
    np.random.seed(0)
    tb = list(DataLoader(tds.Cifar10(data_file=c10), batch_size=8,
                         shuffle=True))
    assert len(tb) == len(jb) == 3
    for (tx, ty), (jx, jy) in zip(tb, jb):
        assert tx.device.type == "cpu" and ty.dtype == torch.int64
        np.testing.assert_array_equal(tx.numpy(), to_np(jx))
        np.testing.assert_array_equal(ty.numpy(), to_np(jy))


# -- vision.ops --

F32_INSIDE = (2e-5, 1e-5)


def _ops_both(name, args, kwargs=None, tol=None):
    kwargs = kwargs or {}
    conv = lambda f: [f(a) if isinstance(a, np.ndarray) else a  # noqa: E731
                      for a in args]
    want = getattr(jops, name)(*conv(paddle.to_tensor), **kwargs)
    got = getattr(tops, name)(*conv(lambda a: torch.from_numpy(a.copy())),
                              **kwargs)
    assert_same(to_np(got), to_np(want), tol)
    return got


BOXES = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30],
                  [21, 19, 31, 29], [0, 0, 9, 10], [50, 50, 60, 70]],
                 np.float64)
SCORES = np.array([0.9, 0.8, 0.7, 0.95, 0.6, 0.5])
CATS = np.array([0, 1, 0, 0, 0, 1], np.int64)


@pytest.mark.parametrize("kw", [{}, {"scores": SCORES},
                                {"scores": SCORES, "top_k": 2},
                                {"scores": SCORES, "category_idxs": CATS},
                                {"iou_threshold": 0.05, "scores": SCORES}],
                         ids=["order", "scores", "top_k", "categories",
                              "tight"])
def test_nms(kw):
    want = jops.nms(paddle.to_tensor(BOXES), **{
        k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    got = tops.nms(torch.from_numpy(BOXES), **{
        k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    assert got.tolist() == to_np(want).tolist()


X_ROI = R.standard_normal((2, 3, 12, 10))
ROI = np.array([[1.0, 2.0, 7.5, 9.0], [0.0, 0.0, 9.0, 11.0],
                [3.2, 1.1, 5.0, 4.0]])
ROI_N = np.array([2, 1], np.int32)


@pytest.mark.parametrize("kw", [{}, {"aligned": False},
                                {"sampling_ratio": 3, "spatial_scale": 0.5},
                                {"output_size": (2, 3)}],
                         ids=["aligned", "legacy", "ratio3", "rect"])
def test_roi_align(kw):
    kw = dict(kw)
    out = kw.pop("output_size", 4)
    _ops_both("roi_align", (X_ROI, ROI, ROI_N, out), kw, tol=F32_INSIDE)
    _ops_both("roi_align", (X_ROI.astype(np.float32),
                            ROI.astype(np.float32), ROI_N, out), kw,
              tol=F32_INSIDE)


def test_roi_pool():
    _ops_both("roi_pool", (X_ROI, ROI, ROI_N, 3))
    _ops_both("roi_pool", (X_ROI, ROI, ROI_N, (2, 4)), {"spatial_scale": 0.5})


PRIOR = np.array([[0.1, 0.1, 0.4, 0.5], [0.3, 0.2, 0.9, 0.8],
                  [0.0, 0.5, 0.5, 1.0]])
TARGET = np.array([[0.2, 0.1, 0.6, 0.7], [0.1, 0.3, 0.4, 0.9]])


@pytest.mark.parametrize("var", [None, np.array([0.1, 0.1, 0.2, 0.2]),
                                 R.uniform(0.1, 0.3, (3, 4))],
                         ids=["no_var", "shared", "per_prior"])
@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_encode_and_decode(var, normalized):
    enc = _ops_both("box_coder", (PRIOR, var, TARGET),
                    {"box_normalized": normalized}, tol=(1e-6, 1e-7))
    _ops_both("box_coder", (PRIOR, var, enc.numpy().astype(np.float64)),
              {"code_type": "decode_center_size",
               "box_normalized": normalized}, tol=(1e-6, 1e-7))


@pytest.mark.parametrize("kw", [
    {"min_sizes": [4.0]},
    {"min_sizes": [4.0, 8.0], "max_sizes": [6.0, 12.0],
     "aspect_ratios": (1.0, 2.0), "flip": True, "clip": True},
    {"min_sizes": [4.0], "max_sizes": [9.0], "aspect_ratios": (2.0, 3.0),
     "min_max_aspect_ratios_order": True, "steps": (4.0, 5.0),
     "offset": 0.25}], ids=["plain", "flip_clip", "ordered_steps"])
def test_prior_box(kw):
    feat, image = np.zeros((1, 8, 3, 4)), np.zeros((1, 3, 12, 16))
    _ops_both("prior_box", (feat, image), kw, tol=(1e-6, 1e-7))


@pytest.mark.parametrize("cfg", [
    dict(groups=1, dg=1, mask=False, stride=1, padding=1),
    dict(groups=1, dg=2, mask=True, stride=2, padding=0),
    dict(groups=2, dg=1, mask=True, stride=1, padding=1)],
    ids=["v1", "v2_dg2", "grouped"])
def test_deform_conv2d(cfg):
    r = np.random.default_rng(5)
    N, C, H, W, Co, k = 2, 4, 6, 5, 6, 3
    s, p = cfg["stride"], cfg["padding"]
    oh = (H + 2 * p - k) // s + 1
    ow = (W + 2 * p - k) // s + 1
    x = r.standard_normal((N, C, H, W))
    w = r.standard_normal((Co, C // cfg["groups"], k, k))
    off = r.standard_normal((N, 2 * cfg["dg"] * k * k, oh, ow)) * 1.5
    mask = r.uniform(0, 1, (N, cfg["dg"] * k * k, oh, ow)) \
        if cfg["mask"] else None
    bias = r.standard_normal(Co)
    _ops_both("deform_conv2d", (x, off, w, bias, s, p, 1, cfg["dg"],
                                cfg["groups"], mask), tol=F32_INSIDE)


# -- ResNet --

def test_resnet50_parameter_counts(fast_jax_init):  # noqa: F811
    for kw, count in (({}, 25_557_032), ({"num_classes": 10}, 23_528_522)):
        t = tm.resnet50(**kw)
        j = jm.resnet50(**kw)
        assert sum(p.numel() for p in t.parameters()) == count
        assert sum(p.size for p in j.parameters()) == count
        assert names_and_shapes(t) == names_and_shapes(j)
        bn = [n for n in t.state_dict() if n.endswith(("_mean", "_variance"))]
        assert "bn1._mean" in bn and len(bn) == 2 * 53


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_forward_matches_jax_both_ways(name, fast_jax_init):  # noqa: F811
    """Seeded numpy weights (and BatchNorm statistics) go into the JAX
    model, from it into the port, and the forwards agree in float64."""
    j = getattr(jm, name)(num_classes=10)
    r = np.random.default_rng(6)
    state = {}
    for n, v in j.state_dict().items():
        shape = tuple(v.shape)
        if n.endswith("_variance"):
            state[n] = r.uniform(0.5, 2.0, shape).astype(np.float32)
        else:
            state[n] = (0.1 * r.standard_normal(shape)).astype(np.float32)
    j.set_state_dict(state)
    t = getattr(tm, name)(num_classes=10)
    weights.from_paddle_tpu_state(
        {n: np.asarray(v.numpy()) for n, v in j.state_dict().items()}, t)
    for n, v in t.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[n], err_msg=n)
    x = np.random.default_rng(7).standard_normal((4, 3, 64, 64))
    forward_parity(j, t, x)
    back = weights.to_numpy_state(t)
    assert sorted(back) == sorted(state)


def test_models_build_on_the_current_device():
    ptt.set_device("cpu")
    t = tm.resnet18(num_classes=4)
    assert {p.device.type for p in t.parameters()} == {"cpu"}
    assert {b.device.type for b in t.buffers()} == {"cpu"}
