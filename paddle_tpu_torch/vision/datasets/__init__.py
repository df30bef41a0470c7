"""Vision datasets: the counterpart of
``paddle_tpu/vision/datasets/__init__.py`` — ``FakeData`` (:19),
``Cifar10`` (:42, ``cifar-10-python.tar.gz``: ``data_batch_1..5`` and
``test_batch``, pickled ``b"data"`` uint8 [N, 3072] and ``b"labels"``),
``Cifar100``, ``MNIST`` / ``FashionMNIST`` (idx files, gzipped or not),
``ImageFolder`` / ``DatasetFolder`` (``.npy`` files by default),
``Flowers`` and ``VOC2012``.

A copy of the JAX module: the datasets read local files in the formats
it parses and yield numpy samples on the host (``download`` is taken and
nothing is fetched; a missing file raises, or, where the JAX dataset
does so, serves its seeded synthetic stand-in with a warning).
Batches reach the card through the port's ``io.DataLoader``.
"""

from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from ...io import Dataset


class FakeData(Dataset):
    """Deterministic synthetic image dataset."""

    def __init__(self, size=1000, image_shape=(3, 32, 32), num_classes=10,
                 transform=None, seed=0):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        img = rng.rand(*self.image_shape).astype("float32")
        label = np.int64(rng.randint(self.num_classes))
        if self.transform is not None:
            img = self.transform(img)
        return img, label


class Cifar10(Dataset):
    """ref: python/paddle/vision/datasets/cifar.py:Cifar10. Reads the
    standard cifar-10-python.tar.gz when available."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        self.backend = backend or "numpy"
        if backend == "synthetic" or data_file == "synthetic":
            self._fake = FakeData(size=50000 if mode == "train" else 10000,
                                  image_shape=(3, 32, 32), num_classes=10,
                                  transform=transform)
            self.data = None
            return
        self._fake = None
        data_file = data_file or os.path.expanduser(
            "~/.cache/paddle/dataset/cifar/cifar-10-python.tar.gz")
        if not os.path.exists(data_file):
            raise FileNotFoundError(
                f"{data_file} not found: nothing is downloaded; place the "
                "archive there or use backend='synthetic'.")
        self.data = []
        with tarfile.open(data_file, mode="r") as f:
            names = [n for n in f.getnames()
                     if ("data_batch" in n if mode == "train"
                         else "test_batch" in n)]
            for name in sorted(names):
                batch = pickle.load(f.extractfile(name), encoding="bytes")
                for x, y in zip(batch[b"data"], batch[b"labels"]):
                    self.data.append((x, y))

    def __len__(self):
        if self._fake is not None:
            return len(self._fake)
        return len(self.data)

    def __getitem__(self, idx):
        if self._fake is not None:
            return self._fake[idx]
        x, y = self.data[idx]
        img = x.reshape(3, 32, 32).astype("float32") / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(y)


class Cifar100(Cifar10):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        self.backend = backend or "numpy"
        if backend == "synthetic" or data_file == "synthetic":
            self._fake = FakeData(size=50000 if mode == "train" else 10000,
                                  image_shape=(3, 32, 32), num_classes=100,
                                  transform=transform)
            self.data = None
            return
        self._fake = None
        data_file = data_file or os.path.expanduser(
            "~/.cache/paddle/dataset/cifar/cifar-100-python.tar.gz")
        if not os.path.exists(data_file):
            raise FileNotFoundError(
                f"{data_file} not found: nothing is downloaded; place the "
                "archive there or use backend='synthetic'.")
        self.data = []
        with tarfile.open(data_file, mode="r") as f:
            name = "train" if mode == "train" else "test"
            member = next(n for n in f.getnames() if n.endswith(name))
            batch = pickle.load(f.extractfile(member), encoding="bytes")
            for x, y in zip(batch[b"data"], batch[b"fine_labels"]):
                self.data.append((x, y))


class MNIST(Dataset):
    """ref: python/paddle/vision/datasets/mnist.py. Synthetic-capable."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.transform = transform
        if backend == "synthetic" or image_path == "synthetic" or (
                image_path is None and label_path is None):
            self._fake = FakeData(size=60000 if mode == "train" else 10000,
                                  image_shape=(1, 28, 28), num_classes=10,
                                  transform=transform)
            return
        self._fake = None
        if not (os.path.exists(image_path) and os.path.exists(label_path)):
            raise FileNotFoundError(
                f"MNIST files {image_path}/{label_path} not found: nothing "
                "is downloaded; place idx files there or use "
                "backend='synthetic'.")
        self.images = self._parse_idx(image_path)
        self.labels = self._parse_idx(label_path)

    @staticmethod
    def _parse_idx(path):
        """Standard idx format (ubyte), optionally gzipped."""
        import gzip
        import struct
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic = struct.unpack(">I", f.read(4))[0]
            ndim = magic & 0xFF
            dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(dims)

    def __len__(self):
        if self._fake is not None:
            return len(self._fake)
        return len(self.labels)

    def __getitem__(self, idx):
        if self._fake is not None:
            return self._fake[idx]
        img = self.images[idx].astype("float32")[None] / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(self.labels[idx])


class FashionMNIST(MNIST):
    pass


class ImageFolder(Dataset):
    """ref: python/paddle/vision/datasets/folder.py — loads images from a
    directory tree (requires PIL or numpy .npy files)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        exts = extensions or (".npy",)
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fname in sorted(files):
                if fname.lower().endswith(tuple(exts)):
                    self.samples.append(os.path.join(dirpath, fname))
        self.loader = loader or (lambda p: np.load(p))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        exts = extensions or (".npy",)
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(tuple(exts)):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))
        self.loader = loader or (lambda p: np.load(p))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target


class Flowers(Dataset):
    """Oxford 102 Flowers (ref: vision/datasets/flowers.py — parses
    102flowers.tgz jpgs + imagelabels.mat + setid.mat splits); synthetic
    fallback with the real label space when no archive is given."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True,
                 backend=None):
        assert mode in ("train", "valid", "test")
        self.transform = transform
        if data_file and os.path.exists(data_file) and label_file and \
                setid_file:
            self._load_real(data_file, label_file, setid_file, mode)
        else:
            import warnings
            warnings.warn(
                "Flowers: dataset files not provided (102flowers.tgz + "
                "imagelabels.mat + setid.mat); serving SYNTHETIC data "
                "with the real 102-class label space.", UserWarning,
                stacklevel=2)
            rng = np.random.default_rng(0)
            self.images = rng.integers(0, 255, (60, 64, 64, 3),
                                       np.uint8)
            self.labels = rng.integers(0, 102, (60,)).astype(np.int64)

    def _load_real(self, data_file, label_file, setid_file, mode):
        import io as _io
        import tarfile
        from scipy.io import loadmat
        labels = loadmat(label_file)["labels"][0] - 1
        setid = loadmat(setid_file)
        idx = {"train": setid["trnid"], "valid": setid["valid"],
               "test": setid["tstid"]}[mode][0]
        wanted = {f"jpg/image_{i:05d}.jpg": i for i in idx}
        images, labs = [], []
        from PIL import Image
        with tarfile.open(data_file) as tf:
            for m in tf.getmembers():
                if m.name in wanted:
                    img = Image.open(_io.BytesIO(
                        tf.extractfile(m).read())).convert("RGB")
                    images.append(np.asarray(img))
                    labs.append(int(labels[wanted[m.name] - 1]))
        self.images = images
        self.labels = np.asarray(labs, np.int64)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = np.asarray(self.images[i])
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[i]


class VOC2012(Dataset):
    """PASCAL VOC2012 segmentation (ref: vision/datasets/voc2012.py —
    parses VOCtrainval tar: JPEGImages + SegmentationClass pngs listed by
    ImageSets/Segmentation/<mode>.txt)."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        assert mode in ("train", "valid", "test")
        self.transform = transform
        if data_file and os.path.exists(data_file):
            self._load_real(data_file, mode)
        else:
            import warnings
            warnings.warn(
                "VOC2012: no data_file (VOCtrainval_11-May-2012.tar); "
                "serving SYNTHETIC image/mask pairs.", UserWarning,
                stacklevel=2)
            rng = np.random.default_rng(1)
            self.images = rng.integers(0, 255, (12, 64, 64, 3), np.uint8)
            self.masks = rng.integers(0, 21, (12, 64, 64)).astype(np.uint8)

    def _load_real(self, data_file, mode):
        import io as _io
        import tarfile
        from PIL import Image
        split = {"train": "train.txt", "valid": "val.txt",
                 "test": "trainval.txt"}[mode]
        with tarfile.open(data_file) as tf:
            names = {m.name: m for m in tf.getmembers()}
            listing = next(n for n in names
                           if n.endswith(f"ImageSets/Segmentation/{split}"))
            ids = tf.extractfile(names[listing]).read().decode().split()
            self.images, self.masks = [], []
            for i in ids:
                jn = next(n for n in names
                          if n.endswith(f"JPEGImages/{i}.jpg"))
                mn = next(n for n in names
                          if n.endswith(f"SegmentationClass/{i}.png"))
                self.images.append(np.asarray(Image.open(_io.BytesIO(
                    tf.extractfile(names[jn]).read())).convert("RGB")))
                self.masks.append(np.asarray(Image.open(_io.BytesIO(
                    tf.extractfile(names[mn]).read()))))

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = np.asarray(self.images[i])
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self.masks[i])
