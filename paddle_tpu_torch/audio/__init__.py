"""``paddle.audio``: the counterpart of ``paddle_tpu/audio/__init__.py``
(``Spectrogram``, ``MelSpectrogram``, ``LogMelSpectrogram``, ``MFCC``,
the ``features``, ``functional`` and ``backends`` namespaces,
``power_to_db``, ``create_dct``, ``mel_frequencies``,
``fft_frequencies``, ``get_window``, ``compute_fbank_matrix``, and the
datasets).

The features are built on the port's ``signal.stft`` (centred, reflect
padding, the JAX layout [..., freq, frames]) and run on the input's
device; their tables (the window, the mel filterbank, the DCT) are
computed on the host in numpy as the JAX package computes them and kept
as buffers on the layer's device (``device=``, default the current
device). The layers take the JAX layers' arguments and, as there, apply
only n_fft, hop_length, window ("hann": numpy's symmetric Hann, else
ones) and power to the spectrogram. ``backends`` reads and writes PCM
wav files with the standard library's ``wave``.
"""

import math

import numpy as np
import torch

from .. import nn


def _dev(device):
    from ..device import resolve_device
    return resolve_device(device)


def hz_to_mel(f):
    return 2595.0 * np.log10(1 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def compute_fbank_matrix(sr, n_fft, n_mels=64, f_min=0.0, f_max=None):
    """Triangular mel filters [n_mels, n_fft // 2 + 1] (numpy float32)."""
    f_max = f_max or sr / 2
    mels = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for i in range(n_mels):
        lo, c, hi = bins[i], bins[i + 1], bins[i + 2]
        for j in range(lo, c):
            if c > lo:
                fb[i, j] = (j - lo) / (c - lo)
        for j in range(c, hi):
            if hi > c:
                fb[i, j] = (hi - j) / (hi - c)
    return fb


class Spectrogram(nn.Layer):
    """|stft(x)| ** power, [..., n_fft // 2 + 1, frames]."""

    def __init__(self, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 dtype="float32", *, device=None):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.power = power
        win = np.hanning(win_length or n_fft).astype("float32") \
            if window == "hann" else np.ones(win_length or n_fft, "float32")
        self.register_buffer("window",
                             torch.from_numpy(win).to(_dev(device)))

    def forward(self, x):
        from ..signal import stft
        spec = stft(x, self.n_fft, self.hop_length, window=self.window)
        return spec.abs() ** self.power


class MelSpectrogram(nn.Layer):
    """The mel filterbank times the power spectrogram."""

    def __init__(self, sr=22050, n_fft=512, hop_length=None, n_mels=64,
                 f_min=50.0, f_max=None, *, device=None, **kw):
        super().__init__()
        self.spectrogram = Spectrogram(n_fft, hop_length, device=device)
        fb = compute_fbank_matrix(sr, n_fft, n_mels, f_min, f_max)
        self.register_buffer("fbank", torch.from_numpy(fb).to(_dev(device)))

    def forward(self, x):
        spec = self.spectrogram(x)             # [..., freq, frames]
        return torch.matmul(self.fbank, spec)


class LogMelSpectrogram(MelSpectrogram):
    """10 log10(max(mel, amin)); ref_value and top_db are taken and, as
    in the JAX layer, not applied."""

    def __init__(self, *a, ref_value=1.0, amin=1e-10, top_db=None, **kw):
        super().__init__(*a, **kw)
        self.amin = amin

    def forward(self, x):
        mel = super().forward(x)
        return 10.0 * torch.log10(torch.clamp_min(mel, self.amin))


class MFCC(nn.Layer):
    """The DCT-II (ortho) of the log-mel spectrogram: [..., n_mfcc,
    frames]."""

    def __init__(self, sr=22050, n_mfcc=40, n_mels=64, *, device=None,
                 **kw):
        super().__init__()
        self.logmel = LogMelSpectrogram(sr=sr, n_mels=n_mels, device=device,
                                        **kw)
        self.register_buffer("dct", create_dct(n_mfcc, n_mels,
                                               device=device))

    def forward(self, x):
        return torch.matmul(self.dct, self.logmel(x))


class features:
    Spectrogram = Spectrogram
    MelSpectrogram = MelSpectrogram
    LogMelSpectrogram = LogMelSpectrogram
    MFCC = MFCC


class functional:
    hz_to_mel = staticmethod(hz_to_mel)
    mel_to_hz = staticmethod(mel_to_hz)
    compute_fbank_matrix = staticmethod(compute_fbank_matrix)


def power_to_db(magnitude, ref_value=1.0, amin=1e-10, top_db=80.0):
    """10 log10(max(x, amin)) - 10 log10(max(ref_value, amin)), floored
    at its max - top_db (on the device: no host read)."""
    x = magnitude if isinstance(magnitude, torch.Tensor) else \
        torch.as_tensor(np.asarray(magnitude))
    db = 10.0 * torch.log10(torch.clamp_min(x, amin))
    db = db - 10.0 * float(np.log10(max(ref_value, amin)))
    if top_db is not None:
        db = torch.maximum(db, db.max() - top_db)
    return db


def create_dct(n_mfcc, n_mels, norm="ortho", *, device=None):
    """The DCT-II matrix [n_mfcc, n_mels] (float32, ortho scaling by
    default), on `device` (default the current device)."""
    dct = np.zeros((n_mfcc, n_mels), np.float32)
    for k in range(n_mfcc):
        dct[k] = np.cos(np.pi * k * (2 * np.arange(n_mels) + 1)
                        / (2 * n_mels))
    if norm == "ortho":
        dct[0] *= 1 / np.sqrt(2)
        dct *= np.sqrt(2.0 / n_mels)
    return torch.from_numpy(dct).to(_dev(device))


functional.power_to_db = staticmethod(power_to_db)
functional.create_dct = staticmethod(create_dct)


class backends:
    """PCM wav IO with the standard library's ``wave`` (8, 16 and 32 bit)."""

    @staticmethod
    def load(filepath, frame_offset=0, num_frames=-1, normalize=True):
        """([channels, frames] float32 on the current device, rate)."""
        import wave as _wave
        with _wave.open(filepath, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            ch = w.getnchannels()
            w.setpos(min(frame_offset, n))
            count = n - frame_offset if num_frames < 0 else num_frames
            raw = w.readframes(count)
            width = w.getsampwidth()
        if width == 2:
            data = np.frombuffer(raw, dtype=np.int16).astype(np.float32)
            scale = 32768.0
        elif width == 4:
            data = np.frombuffer(raw, dtype=np.int32).astype(np.float32)
            scale = 2147483648.0
        elif width == 1:   # 8-bit PCM is unsigned
            data = np.frombuffer(raw, dtype=np.uint8).astype(
                np.float32) - 128.0
            scale = 128.0
        else:
            raise ValueError(f"unsupported wav sample width {width}")
        data = data.reshape(-1, ch).T
        if normalize:
            data = data / scale
        return torch.from_numpy(np.ascontiguousarray(data)).to(_dev(None)), sr

    @staticmethod
    def save(filepath, src, sample_rate, channels_first=True,
             bits_per_sample=16):
        import wave as _wave
        arr = src.detach().cpu().numpy() if isinstance(src, torch.Tensor) \
            else np.asarray(src)
        if arr.ndim == 1:
            arr = arr[None]
        if not channels_first:
            arr = arr.T
        if bits_per_sample == 16:
            pcm = np.clip(arr * 32768.0, -32768, 32767).astype(np.int16)
            width = 2
        elif bits_per_sample == 32:
            pcm = np.clip(arr * 2147483648.0, -2147483648,
                          2147483647).astype(np.int32)
            width = 4
        elif bits_per_sample == 8:
            pcm = np.clip(arr * 128.0 + 128.0, 0, 255).astype(np.uint8)
            width = 1
        else:
            raise ValueError(
                f"unsupported bits_per_sample {bits_per_sample}")
        with _wave.open(filepath, "wb") as w:
            w.setnchannels(pcm.shape[0])
            w.setsampwidth(width)
            w.setframerate(int(sample_rate))
            w.writeframes(pcm.T.tobytes())

    @staticmethod
    def info(filepath):
        import wave as _wave
        with _wave.open(filepath, "rb") as w:
            class _Info:
                sample_rate = w.getframerate()
                num_frames = w.getnframes()
                num_channels = w.getnchannels()
                bits_per_sample = w.getsampwidth() * 8
            return _Info()


load = backends.load
save = backends.save
info = backends.info


def mel_frequencies(n_mels=64, f_min=0.0, f_max=11025.0, htk=False,
                    dtype="float32"):
    """n_mels frequencies evenly spaced in mel between f_min and f_max."""
    from ..framework.dtype import convert_dtype
    lo, hi = hz_to_mel(f_min), hz_to_mel(f_max)
    mels = np.linspace(lo, hi, n_mels)
    return torch.as_tensor(np.asarray([mel_to_hz(m) for m in mels]),
                           dtype=convert_dtype(dtype), device=_dev(None))


def fft_frequencies(sr, n_fft, dtype="float32"):
    """The 1 + n_fft // 2 bin frequencies from 0 to sr / 2."""
    from ..framework.dtype import convert_dtype
    return torch.linspace(0, sr / 2, 1 + n_fft // 2,
                          dtype=convert_dtype(dtype), device=_dev(None))


def get_window(window, win_length, fftbins=True, dtype="float32"):
    """A cosine-sum (or triangular, Gaussian, rectangular) window,
    computed in float64 and cast to `dtype`."""
    from ..framework.dtype import convert_dtype
    name = window if isinstance(window, str) else window[0]
    n = win_length
    k = np.arange(n, dtype=np.float64)
    denom = n if fftbins else n - 1
    if name in ("hann", "hanning"):
        w = 0.5 - 0.5 * np.cos(2 * math.pi * k / denom)
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * math.pi * k / denom)
    elif name == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * math.pi * k / denom)
             + 0.08 * np.cos(4 * math.pi * k / denom))
    elif name in ("rect", "boxcar", "ones"):
        w = np.ones((n,))
    elif name == "triang":
        w = 1 - np.abs((k - (n - 1) / 2) / ((n + 1) / 2 if fftbins
                                            else (n - 1) / 2))
    elif name == "bartlett":
        w = 1 - np.abs((k - (n - 1) / 2) / ((n - 1) / 2))
    elif name == "gaussian":
        std = window[1] if isinstance(window, tuple) else 7.0
        w = np.exp(-0.5 * ((k - (n - 1) / 2) / std) ** 2)
    else:
        raise ValueError(f"unsupported window {name}")
    return torch.as_tensor(w, dtype=convert_dtype(dtype), device=_dev(None))


functional.mel_frequencies = staticmethod(mel_frequencies)
functional.fft_frequencies = staticmethod(fft_frequencies)
functional.get_window = staticmethod(get_window)

from . import datasets  # noqa: E402,F401  (ESC50, TESS)

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC",
           "features", "functional", "backends", "power_to_db",
           "create_dct", "mel_frequencies", "fft_frequencies", "get_window",
           "compute_fbank_matrix", "hz_to_mel", "mel_to_hz", "load", "save",
           "info", "datasets"]
