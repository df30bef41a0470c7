"""The port's ``text`` and ``audio`` against the JAX package's, on the CPU.

- ``viterbi_decode`` / ``ViterbiDecoder``: scores to 1e-6 and paths
  equal, tied potentials included (argmax ties to the lower tag);
- the audio features (Spectrogram, MelSpectrogram, LogMelSpectrogram,
  MFCC) on the same seeded clips: power spectra to 1e-4 of their largest
  (float32 FFTs), the dB features within 1e-2 dB (a bin whose power is
  tiny takes its float32 rounding into the log); the functional helpers
  (filterbank, DCT, mel and FFT frequencies, windows, power_to_db) to
  float32 rounding; ``backends`` save / load round trips read by the
  other package;
- every dataset over a small archive the test writes in the format the
  JAX parser reads (IMDB tar, PTB tgz, housing.data, the CoNLL-05 tar
  with its dicts, the MovieLens zip, the WMT14 tgz, the WMT16 tar, the
  ESC-50 folder and CSV, the TESS folder): the same items; and without a
  file the same synthetic items with the same UserWarning.
"""

import gzip
import io
import os
import tarfile
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.audio as JA
import paddle_tpu.audio.datasets as JAD
import paddle_tpu.text as JT

import paddle_tpu_torch as ptt  # noqa: F401
import paddle_tpu_torch.audio as TA
import paddle_tpu_torch.audio.datasets as TAD
import paddle_tpu_torch.text as TT
from torch_parity import cpu_device, rng  # noqa: F401

torch.set_num_threads(1)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    if hasattr(v, "numpy"):
        return np.asarray(v.numpy())
    return np.asarray(v)


# -- viterbi ----------------------------------------------------------------------

@pytest.mark.parametrize("tied", [False, True])
def test_viterbi_matches_jax(tied):
    r = rng(1)
    if tied:
        pot = r.integers(0, 3, (4, 9, 5)).astype(np.float32)
        trans = r.integers(-1, 2, (5, 5)).astype(np.float32)
    else:
        pot = r.standard_normal((4, 9, 5)).astype(np.float32)
        trans = r.standard_normal((5, 5)).astype(np.float32)
    lens = np.full((4,), 9, np.int64)
    js, jp = JT.viterbi_decode(paddle.to_tensor(pot), paddle.to_tensor(trans),
                               paddle.to_tensor(lens))
    ts, tp = TT.viterbi_decode(torch.from_numpy(pot), torch.from_numpy(trans),
                               torch.from_numpy(lens))
    np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-6)
    np.testing.assert_array_equal(_np(tp), _np(jp))
    assert tp.shape == (4, 9)
    dec = TT.ViterbiDecoder(torch.from_numpy(trans))
    assert torch.equal(dec(torch.from_numpy(pot), None)[1], tp)


# -- audio features -----------------------------------------------------------------

def _clips(n=2, length=4000, seed=2):
    t = np.arange(length) / 16000.0
    r = rng(seed)
    return np.stack([np.sin(2 * np.pi * (200 + 300 * i) * t) * 0.5
                     + 0.1 * r.standard_normal(length)
                     for i in range(n)]).astype(np.float32)


FEATURES = [("Spectrogram", {"n_fft": 256}),
            ("MelSpectrogram", {"sr": 16000, "n_fft": 256, "n_mels": 32}),
            ("LogMelSpectrogram", {"sr": 16000, "n_fft": 256, "n_mels": 32}),
            ("MFCC", {"sr": 16000, "n_mfcc": 13, "n_mels": 32,
                      "n_fft": 256})]


@pytest.mark.parametrize("name,kw", FEATURES, ids=[f[0] for f in FEATURES])
def test_audio_features_match_jax(name, kw):
    x = _clips()
    want = _np(getattr(JA, name)(**kw)(paddle.to_tensor(x)))
    layer = getattr(TA, name)(**kw)
    got = _np(layer(torch.from_numpy(x)))
    assert got.shape == want.shape
    if name in ("LogMelSpectrogram", "MFCC"):
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)
    else:
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert set(layer.state_dict()) == set(
        getattr(JA, name)(**kw).state_dict())


def test_audio_functional_matches_jax():
    fb_t = TA.compute_fbank_matrix(16000, 512, 40, 20.0, 7000.0)
    np.testing.assert_array_equal(
        fb_t, JA.compute_fbank_matrix(16000, 512, 40, 20.0, 7000.0))
    np.testing.assert_array_equal(_np(TA.create_dct(13, 40)),
                                  _np(JA.create_dct(13, 40)))
    np.testing.assert_allclose(_np(TA.mel_frequencies(20, 30.0, 8000.0)),
                               _np(JA.mel_frequencies(20, 30.0, 8000.0)),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(TA.fft_frequencies(16000, 512)),
                               _np(JA.fft_frequencies(16000, 512)),
                               rtol=1e-6, atol=1e-4)
    for win in ("hann", "hamming", "blackman", "rect", "triang", "bartlett",
                ("gaussian", 3.0)):
        for fftbins in (True, False):
            np.testing.assert_allclose(
                _np(TA.get_window(win, 16, fftbins)),
                _np(JA.get_window(win, 16, fftbins)), rtol=1e-6, atol=1e-7,
                err_msg=str(win))
    mag = rng(3).uniform(1e-12, 10.0, (3, 20)).astype(np.float32)
    for top_db in (80.0, 20.0, None):
        np.testing.assert_allclose(
            _np(TA.power_to_db(torch.from_numpy(mag), 2.0, top_db=top_db)),
            _np(JA.power_to_db(paddle.to_tensor(mag), 2.0, top_db=top_db)),
            rtol=1e-5, atol=1e-4)
    assert TA.functional.get_window is not None and TA.features.MFCC is \
        TA.MFCC


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_backends_round_trip_across_packages(tmp_path, bits):
    x = (_clips(2, 800) * 0.9).astype(np.float32)
    a, b = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    TA.save(a, torch.from_numpy(x), 8000, bits_per_sample=bits)
    JA.save(b, paddle.to_tensor(x), 8000, bits_per_sample=bits)
    assert open(a, "rb").read() == open(b, "rb").read()
    tw, tsr = TA.load(b)
    jw, jsr = JA.load(a)
    assert tsr == jsr == 8000
    np.testing.assert_array_equal(_np(tw), _np(jw))
    assert np.abs(_np(tw) - x).max() < 2.0 ** (1 - bits) * 2
    ti, ji = TA.info(a), JA.info(a)
    assert (ti.sample_rate, ti.num_frames, ti.num_channels,
            ti.bits_per_sample) == (ji.sample_rate, ji.num_frames,
                                    ji.num_channels, ji.bits_per_sample)


# -- datasets -----------------------------------------------------------------------

def _same_items(tds, jds, n=None):
    assert len(tds) == len(jds)
    for i in range(len(jds) if n is None else min(n, len(jds))):
        ti, ji = tds[i], jds[i]
        ti = ti if isinstance(ti, tuple) else (ti,)
        ji = ji if isinstance(ji, tuple) else (ji,)
        assert len(ti) == len(ji)
        for a, b in zip(ti, ji):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _imdb(path):
    words = ["good", "bad", "film", "plot", "great", "dull"]
    r = rng(4)
    with tarfile.open(path, "w:gz") as tf:
        for split in ("train", "test"):
            for lab in ("pos", "neg"):
                for i in range(4):
                    text = " ".join(r.choice(words, 12)) + "! The END."
                    _add(tf, f"aclImdb/{split}/{lab}/{i}_7.txt",
                         text.encode())


def _ptb(path):
    r = rng(5)
    words = [f"w{i}" for i in range(8)]
    with tarfile.open(path, "w:gz") as tf:
        for split in ("train", "valid"):
            lines = "\n".join(" ".join(r.choice(words, 7))
                              for _ in range(10))
            _add(tf, f"./simple-examples/data/ptb.{split}.txt",
                 lines.encode())


def _housing(path):
    np.savetxt(path, rng(6).uniform(0, 10, (20, 14)))


def _conll(tmp):
    words = ["The", "cat", "sat", "on", "mat", "."]
    props = ["-    (A0*", "-    *)", "sit  (V*)", "-    (AM-LOC*",
             "-    *)", "-    *"]
    path = str(tmp / "conll05st-tests.tar.gz")
    with tarfile.open(path, "w:gz") as tf:
        _add(tf, "conll05st-release/test.wsj/words/test.wsj.words.gz",
             gzip.compress(("\n".join(words * 1) + "\n\n").encode()))
        _add(tf, "conll05st-release/test.wsj/props/test.wsj.props.gz",
             gzip.compress(("\n".join(props) + "\n\n").encode()))
    dicts = {}
    for name, vocab in (("word", ["<unk>", "the", "cat", "sat", "on",
                                  "mat", "."]),
                        ("verb", ["sit"]),
                        ("target", ["O", "B-A0", "I-A0", "B-V",
                                    "B-AM-LOC", "I-AM-LOC"])):
        dicts[name] = str(tmp / f"{name}Dict.txt")
        with open(dicts[name], "w") as f:
            f.write("\n".join(vocab) + "\n")
    return path, dicts


def _movielens(path):
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ml-1m/users.dat", "1::M::25::4::12345\n2::F::35::7::9\n")
        z.writestr("ml-1m/movies.dat", "10::Toy Story (1995)::Animation|"
                   "Comedy\n20::Heat (1995)::Action\n")
        z.writestr("ml-1m/ratings.dat", "\n".join(
            f"{u}::{m}::{(u + m) % 5 + 1}::978300760"
            for u in (1, 2) for m in (10, 20) for _ in range(3)) + "\n")


def _wmt14(path):
    with tarfile.open(path, "w:gz") as tf:
        _add(tf, "wmt14/src.dict", b"<s>\n<e>\n<unk>\nhello\nworld\n")
        _add(tf, "wmt14/trg.dict", b"<s>\n<e>\n<unk>\nbonjour\nmonde\n")
        _add(tf, "wmt14/train/train.gz", gzip.compress(
            b"hello world\tbonjour monde\nworld\tmonde\nhello x\tbonjour\n"))


def _wmt16(path):
    with tarfile.open(path, "w:gz") as tf:
        for split in ("train", "test"):
            _add(tf, f"wmt16/{split}.tok.bpe.32000.en",
                 b"a b c\nb c\nc a a\n")
            _add(tf, f"wmt16/{split}.tok.bpe.32000.de",
                 b"x y\ny z z\nz\n")


def test_text_datasets_over_archives(tmp_path):
    _imdb(p := str(tmp_path / "aclImdb_v1.tar.gz"))
    for mode in ("train", "test"):
        _same_items(TT.Imdb(p, mode, cutoff=2), JT.Imdb(p, mode, cutoff=2))
    assert TT.Imdb(p, cutoff=2).word_idx == JT.Imdb(p, cutoff=2).word_idx
    _ptb(p := str(tmp_path / "simple-examples.tgz"))
    for dt in ("NGRAM", "SEQ"):
        for mode in ("train", "test"):
            _same_items(TT.Imikolov(p, dt, 3, mode, min_word_freq=2),
                        JT.Imikolov(p, dt, 3, mode, min_word_freq=2))
    _housing(p := str(tmp_path / "housing.data"))
    for mode in ("train", "test"):
        _same_items(TT.UCIHousing(p, mode), JT.UCIHousing(p, mode))
    p, d = _conll(tmp_path)
    args = (p, d["word"], d["verb"], d["target"])
    _same_items(TT.Conll05st(*args), JT.Conll05st(*args))
    assert TT.Conll05st(*args).get_dict() == JT.Conll05st(*args).get_dict()
    _movielens(p := str(tmp_path / "ml-1m.zip"))
    for mode in ("train", "test"):
        _same_items(TT.Movielens(p, mode, test_ratio=0.3),
                    JT.Movielens(p, mode, test_ratio=0.3))
    _wmt14(p := str(tmp_path / "wmt14.tgz"))
    _same_items(TT.WMT14(p, "train"), JT.WMT14(p, "train"))
    assert TT.WMT14(p).get_dict(True) == JT.WMT14(p).get_dict(True)
    _wmt16(p := str(tmp_path / "wmt16.tar.gz"))
    for mode in ("train", "test"):
        _same_items(TT.WMT16(p, mode), JT.WMT16(p, mode))


@pytest.mark.parametrize("name", ["Imdb", "Imikolov", "UCIHousing",
                                  "Conll05st", "Movielens", "WMT14",
                                  "WMT16"])
def test_text_synthetic_data_equals_jax(name):
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        tds = getattr(TT, name)()
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        jds = getattr(JT, name)()
    _same_items(tds, jds, 50)


def _wav(path, sr, seconds, seed):
    x = rng(seed).uniform(-0.5, 0.5, int(sr * seconds)).astype(np.float32)
    TA.save(path, torch.from_numpy(x), sr)


@pytest.fixture
def audio_home(tmp_path, monkeypatch):
    esc = tmp_path / "ESC-50-master"
    (esc / "meta").mkdir(parents=True)
    (esc / "audio").mkdir()
    rows = ["filename,fold,target,category,esc10,src_file,take"]
    for i in range(6):
        fname = f"{i % 5 + 1}-{1000 + i}-A-{i}.wav"
        _wav(str(esc / "audio" / fname), 8000, 0.25, i)
        rows.append(f"{fname},{i % 5 + 1},{i * 7 % 50},x,False,{i},A")
    (esc / "meta" / "esc50.csv").write_text("\n".join(rows) + "\n")
    tess = tmp_path / "TESS_Toronto_emotional_speech_set_data" / "OAF_x"
    tess.mkdir(parents=True)
    for i, emo in enumerate(["angry", "happy", "sad", "ps", "fear",
                             "neutral", "bored"]):
        _wav(str(tess / f"OAF_w{i}_{emo}.wav"), 8000, 0.2, 10 + i)
    for mod in (TAD, JAD):
        monkeypatch.setattr(mod, "DATA_HOME", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("feat", ["raw", "mfcc"])
def test_audio_datasets_over_files(audio_home, feat):
    kw = {} if feat == "raw" else {"n_mfcc": 8, "n_mels": 16, "n_fft": 256}
    for mode in ("train", "dev"):
        t = TAD.ESC50(mode=mode, split=2, feat_type=feat, **kw)
        j = JAD.ESC50(mode=mode, split=2, feat_type=feat, **kw)
        assert t.labels == j.labels and len(t) == len(j)
        for i in range(len(j)):
            a, b = t[i], j[i]
            assert a[1] == b[1]
            np.testing.assert_allclose(a[0], b[0], atol=1e-2 if feat !=
                                       "raw" else 0)
    t = TAD.TESS(mode="train", n_folds=2, split=1)
    j = JAD.TESS(mode="train", n_folds=2, split=1)
    assert t.files == j.files and t.labels == j.labels
    _same_items(t, j)


def test_audio_synthetic_data_equals_jax(tmp_path, monkeypatch):
    for mod in (TAD, JAD):
        monkeypatch.setattr(mod, "DATA_HOME", str(tmp_path / "none"))
    for cls in ("ESC50", "TESS"):
        with pytest.warns(UserWarning):
            t = getattr(TAD, cls)(mode="dev")
        with pytest.warns(UserWarning):
            j = getattr(JAD, cls)(mode="dev")
        _same_items(t, j, 3)
    with pytest.raises(RuntimeError):
        TAD.AudioClassificationDataset([], [], feat_type="nope")
