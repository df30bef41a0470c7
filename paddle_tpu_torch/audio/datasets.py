"""The audio classification datasets: the counterpart of
``paddle_tpu/audio/datasets.py`` (``AudioClassificationDataset``, ESC50,
TESS).

Nothing is downloaded. With the extracted archive under ``DATA_HOME``
(``PADDLE_TPU_DATA_HOME``, the JAX package's variable and default) the
folder and CSV layouts are read as the JAX package reads them;
otherwise each serves the JAX package's synthetic stand-in (the same
seeded numpy waveforms and labels, the same warning). A feature
(``feat_type``) is extracted per record by the port's feature layers on
the current device and returned as a numpy array.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from ..io import Dataset
from . import MFCC, LogMelSpectrogram, MelSpectrogram, Spectrogram
from . import backends

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA_HOME",
    os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu", "datasets"))

_FEATS = {
    "raw": None,
    "melspectrogram": MelSpectrogram,
    "mfcc": MFCC,
    "logmelspectrogram": LogMelSpectrogram,
    "spectrogram": Spectrogram,
}


def _synthetic_warning(name, expected):
    warnings.warn(
        f"{name}: dataset files not found (expected {expected} under "
        f"{DATA_HOME}); serving SYNTHETIC random audio with the real "
        f"label space. Point PADDLE_TPU_DATA_HOME at the extracted "
        f"archive for real data.", stacklevel=3)


class AudioClassificationDataset(Dataset):
    """ref: audio/datasets/dataset.py AudioClassificationDataset — holds
    (files, labels), loads waveforms lazily, optionally extracts a
    feature (mfcc / melspectrogram / …) per record."""

    def __init__(self, files, labels, feat_type="raw", sample_rate=None,
                 synthetic_samples=None, synthetic_sr=22050,
                 synthetic_len=22050, **kwargs):
        if feat_type not in _FEATS:
            raise RuntimeError(
                f"Unknown feat_type: {feat_type}, must be one of "
                f"{list(_FEATS)}")
        self.files = files
        self.labels = labels
        self.feat_type = feat_type
        self.sample_rate = sample_rate
        self.feat_config = kwargs
        self._synthetic = synthetic_samples
        self._syn_sr = synthetic_sr
        self._syn_len = synthetic_len

    def _waveform(self, idx):
        if self._synthetic is not None:
            rng = np.random.default_rng(idx)
            return (rng.standard_normal(self._syn_len).astype(np.float32),
                    self._syn_sr)
        wav, sr = backends.load(self.files[idx])
        wav = wav.cpu().numpy().astype(np.float32)
        if wav.ndim == 2:
            wav = wav[0]
        return wav, sr

    def __len__(self):
        return (self._synthetic if self._synthetic is not None
                else len(self.files))

    def _extractor(self, sr):
        """Cache the feature extractor per sample rate: rebuilding the mel
        filterbank per record dominates loading time otherwise."""
        cache = getattr(self, "_fe_cache", None)
        if cache is None:
            cache = self._fe_cache = {}
        if sr not in cache:
            feat_cls = _FEATS[self.feat_type]
            if self.feat_type != "spectrogram":
                cache[sr] = feat_cls(sr=sr, **self.feat_config)
            else:
                cache[sr] = feat_cls(**self.feat_config)
        return cache[sr]

    def __getitem__(self, idx):
        wav, sr = self._waveform(idx)
        self.sample_rate = sr
        label = self.labels[idx]
        if _FEATS[self.feat_type] is None:
            return wav, label
        from .. import to_tensor
        x = to_tensor(wav[None, :])
        feat = self._extractor(sr)(x)
        return feat.detach().cpu().numpy()[0], label


class ESC50(AudioClassificationDataset):
    """ref: audio/datasets/esc50.py. 2000 5-second recordings, 50
    classes; fold-based split from meta/esc50.csv (train = fold != split,
    dev = fold == split)."""

    meta = os.path.join("ESC-50-master", "meta", "esc50.csv")
    audio_path = os.path.join("ESC-50-master", "audio")
    label_list = [
        "Dog", "Rooster", "Pig", "Cow", "Frog", "Cat", "Hen",
        "Insects (flying)", "Sheep", "Crow",
        "Rain", "Sea waves", "Crackling fire", "Crickets",
        "Chirping birds", "Water drops", "Wind", "Pouring water",
        "Toilet flush", "Thunderstorm",
        "Crying baby", "Sneezing", "Clapping", "Breathing", "Coughing",
        "Footsteps", "Laughing", "Brushing teeth", "Snoring",
        "Drinking - sipping",
        "Door knock", "Mouse click", "Keyboard typing",
        "Door - wood creaks", "Can opening", "Washing machine",
        "Vacuum cleaner", "Clock alarm", "Clock tick", "Glass breaking",
        "Helicopter", "Chainsaw", "Siren", "Car horn", "Engine", "Train",
        "Church bells", "Airplane", "Fireworks", "Hand saw",
    ]

    def __init__(self, mode="train", split=1, feat_type="raw", **kwargs):
        assert split in range(1, 6), f"1 <= split <= 5, got {split}"
        meta_path = os.path.join(DATA_HOME, self.meta)
        if os.path.isfile(meta_path):
            files, labels = self._load_real(mode, split, meta_path)
            super().__init__(files, labels, feat_type, **kwargs)
        else:
            _synthetic_warning("ESC50", self.meta)
            n = 80 if mode == "train" else 20
            rng = np.random.default_rng(0)
            labels = rng.integers(0, len(self.label_list), n).tolist()
            super().__init__([None] * n, labels, feat_type,
                             synthetic_samples=n, synthetic_sr=44100,
                             synthetic_len=44100, **kwargs)

    def _load_real(self, mode, split, meta_path):
        files, labels = [], []
        with open(meta_path) as rf:
            for line in rf.readlines()[1:]:
                fname, fold, target = line.strip().split(",")[:3]
                sel = (int(fold) != split if mode == "train"
                       else int(fold) == split)
                if sel:
                    files.append(os.path.join(DATA_HOME, self.audio_path,
                                              fname))
                    labels.append(int(target))
        return files, labels


class TESS(AudioClassificationDataset):
    """ref: audio/datasets/tess.py. Toronto emotional speech set: 2800
    wavs named <speaker>_<word>_<emotion>.wav; modulo-n_folds split."""

    audio_path = "TESS_Toronto_emotional_speech_set_data"
    label_list = ["angry", "disgust", "fear", "happy", "neutral",
                  "ps", "sad"]

    def __init__(self, mode="train", n_folds=5, split=1, feat_type="raw",
                 **kwargs):
        assert n_folds >= 1 and split in range(1, n_folds + 1)
        root = os.path.join(DATA_HOME, self.audio_path)
        if os.path.isdir(root):
            files, labels = self._load_real(mode, n_folds, split, root)
            super().__init__(files, labels, feat_type, **kwargs)
        else:
            _synthetic_warning("TESS", self.audio_path)
            n = 80 if mode == "train" else 20
            rng = np.random.default_rng(0)
            labels = rng.integers(0, len(self.label_list), n).tolist()
            super().__init__([None] * n, labels, feat_type,
                             synthetic_samples=n, synthetic_sr=24414,
                             synthetic_len=24414, **kwargs)

    def _load_real(self, mode, n_folds, split, root):
        wavs = []
        for r, _, fs in os.walk(root):
            for f in fs:
                if f.endswith(".wav"):
                    wavs.append(os.path.join(r, f))
        wavs.sort()
        files, labels = [], []
        for idx, path in enumerate(wavs):
            emotion = os.path.basename(path)[:-4].split("_")[-1].lower()
            if emotion not in self.label_list:
                continue
            target = self.label_list.index(emotion)
            fold = idx % n_folds + 1
            sel = fold != split if mode == "train" else fold == split
            if sel:
                files.append(path)
                labels.append(target)
        return files, labels


__all__ = ["AudioClassificationDataset", "ESC50", "TESS", "DATA_HOME"]
