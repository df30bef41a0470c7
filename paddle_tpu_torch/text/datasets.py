"""Text datasets over local archives: the counterpart of
``paddle_tpu/text/datasets.py`` (Imdb, Imikolov, UCIHousing, Conll05st,
Movielens, WMT14, WMT16).

Nothing is downloaded. Each dataset parses the archive format the JAX
package parses (the file Paddle downloads) when ``data_file`` names it;
without one it serves the JAX package's deterministic synthetic data
(the same numpy draws, so the same items) with the same ``UserWarning``
naming the expected archive. The items are numpy arrays, as in JAX.
"""

from __future__ import annotations

import collections
import io
import re
import os
import tarfile
import warnings

import numpy as np

from ..io import Dataset


def _synthetic_warning(name, expected):
    warnings.warn(
        f"{name}: no data_file provided and downloads are disabled; "
        f"serving deterministic SYNTHETIC data. Provide the real archive "
        f"({expected}) via data_file= for the reference dataset.",
        UserWarning, stacklevel=3)


class Imdb(Dataset):
    """IMDB sentiment (ref: text/datasets/imdb.py — parses aclImdb_v1.tar.gz
    with per-split pos/neg .txt members, builds a frequency-cutoff word
    dict)."""

    def __init__(self, data_file=None, mode="train", cutoff=150,
                 download=True):
        assert mode in ("train", "test")
        self.mode = mode
        if data_file and os.path.exists(data_file):
            self._load_real(data_file, mode, cutoff)
        else:
            _synthetic_warning("Imdb", "aclImdb_v1.tar.gz")
            self._load_synthetic()

    def _tokenize(self, text):
        return re.sub(r"[^a-z0-9\s]", "", text.lower()).split()

    def _load_real(self, data_file, mode, cutoff):
        pos_pat = re.compile(rf"aclImdb/{mode}/pos/.*\.txt$")
        neg_pat = re.compile(rf"aclImdb/{mode}/neg/.*\.txt$")
        docs, labels = [], []
        freq = collections.Counter()
        with tarfile.open(data_file) as tf:
            members = tf.getmembers()
            for pat, label in ((pos_pat, 0), (neg_pat, 1)):
                for m in members:
                    if pat.search(m.name):
                        toks = self._tokenize(
                            tf.extractfile(m).read().decode(
                                "utf-8", "ignore"))
                        docs.append(toks)
                        labels.append(label)
                        freq.update(toks)
        # frequency-sorted dict with cutoff (ref imdb.py word_dict)
        kept = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
        self.word_idx = {}
        for w, c in kept:
            if c < cutoff and len(self.word_idx) > 0:
                break
            self.word_idx[w] = len(self.word_idx)
        unk = self.word_idx.setdefault("<unk>", len(self.word_idx))
        self.docs = [np.asarray([self.word_idx.get(t, unk) for t in d],
                                dtype="int64") for d in docs]
        self.labels = np.asarray(labels, dtype="int64")

    def _load_synthetic(self, size=2000, vocab=5000, seq=64):
        rng = np.random.RandomState(0 if self.mode == "train" else 1)
        self.word_idx = {f"w{i}": i for i in range(vocab)}
        self.docs = [rng.randint(0, vocab, seq).astype("int64")
                     for _ in range(size)]
        self.labels = rng.randint(0, 2, size).astype("int64")

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, i):
        return self.docs[i], self.labels[i]


class Imikolov(Dataset):
    """PTB language-model dataset (ref: text/datasets/imikolov.py — parses
    simple-examples.tgz ptb.{train,valid}.txt, min-freq word dict, NGRAM or
    SEQ samples)."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50, download=True):
        assert data_type in ("NGRAM", "SEQ")
        self.data_type = data_type
        self.window_size = window_size
        self.mode = mode
        if data_file and os.path.exists(data_file):
            self._load_real(data_file, mode, min_word_freq)
        else:
            _synthetic_warning("Imikolov", "simple-examples.tgz (PTB)")
            self._load_synthetic()

    def _load_real(self, data_file, mode, min_word_freq):
        split = "train" if mode == "train" else "valid"
        path = f"./simple-examples/data/ptb.{split}.txt"
        with tarfile.open(data_file) as tf:
            train_f = tf.extractfile(
                "./simple-examples/data/ptb.train.txt")
            freq = collections.Counter()
            for line in io.TextIOWrapper(train_f, "utf-8"):
                freq.update(line.strip().split())
            freq.pop("<unk>", None)
            kept = sorted(((w, c) for w, c in freq.items()
                           if c >= min_word_freq),
                          key=lambda kv: (-kv[1], kv[0]))
            self.word_idx = {w: i for i, (w, c) in enumerate(kept)}
            unk = self.word_idx.setdefault("<unk>", len(self.word_idx))
            self.word_idx["<s>"] = len(self.word_idx)
            self.word_idx["<e>"] = len(self.word_idx)
            data_f = tf.extractfile(path)
            self.samples = []
            for line in io.TextIOWrapper(data_f, "utf-8"):
                toks = (["<s>"] + line.strip().split() + ["<e>"])
                ids = [self.word_idx.get(t, unk) for t in toks]
                if self.data_type == "NGRAM":
                    for i in range(len(ids) - self.window_size + 1):
                        self.samples.append(np.asarray(
                            ids[i:i + self.window_size], dtype="int64"))
                else:
                    self.samples.append(np.asarray(ids, dtype="int64"))

    def _load_synthetic(self, size=20000, vocab=2000):
        rng = np.random.RandomState(2 if self.mode == "train" else 3)
        self.word_idx = {f"w{i}": i for i in range(vocab)}
        self.samples = [rng.randint(0, vocab, self.window_size).astype(
            "int64") for _ in range(size)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        s = self.samples[i]
        if self.data_type == "NGRAM":
            return s[:-1], s[-1:]
        return s

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class UCIHousing(Dataset):
    """Boston housing regression (ref: text/datasets/uci_housing.py —
    whitespace floats, 14 columns, feature normalization, 80/20 split)."""

    FEATURES = 13

    def __init__(self, data_file=None, mode="train", download=True):
        assert mode in ("train", "test")
        if data_file and os.path.exists(data_file):
            raw = np.fromfile(data_file, sep=" ") \
                if not data_file.endswith(".data") else np.loadtxt(data_file)
            data = raw.reshape(-1, self.FEATURES + 1).astype("float32")
            # normalize features to [min,max]-scaled means (ref semantics:
            # (x - avg) / (max - min))
            feats = data[:, :-1]
            avg = feats.mean(0)
            rng_ = feats.max(0) - feats.min(0)
            rng_[rng_ == 0] = 1.0
            data[:, :-1] = (feats - avg) / rng_
            split = int(len(data) * 0.8)
            part = data[:split] if mode == "train" else data[split:]
        else:
            _synthetic_warning("UCIHousing", "housing.data")
            rng = np.random.RandomState(0)
            n = 404 if mode == "train" else 102
            x = rng.rand(n, self.FEATURES).astype("float32")
            w = rng.rand(self.FEATURES, 1).astype("float32")
            y = (x @ w + 0.1 * rng.randn(n, 1)).astype("float32")
            part = np.concatenate([x, y], 1)
        self.x = part[:, :-1]
        self.y = part[:, -1:]

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class Conll05st(Dataset):
    """CoNLL-2005 SRL test set (ref: text/datasets/conll05.py — parses the
    conll05st-tests tar with words/props member files plus word/verb/
    target dicts; yields per-predicate samples of (word_ids, ctx_n2..ctx_p2
    windows, mark, label_ids))."""

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, emb_file=None,
                 download=True):
        if data_file and os.path.exists(data_file):
            self._load_real(data_file, word_dict_file, verb_dict_file,
                            target_dict_file)
        else:
            _synthetic_warning("Conll05st", "conll05st-tests.tar.gz + "
                               "wordDict/verbDict/targetDict files")
            self._load_synthetic()

    def _read_dict(self, path):
        with open(path) as f:
            return {w.strip(): i for i, w in enumerate(f) if w.strip()}

    def _load_real(self, data_file, word_dict_file, verb_dict_file,
                   target_dict_file):
        self.word_dict = self._read_dict(word_dict_file)
        self.verb_dict = self._read_dict(verb_dict_file)
        self.label_dict = self._read_dict(target_dict_file)
        words_lines, props_lines = [], []
        with tarfile.open(data_file) as tf:
            for m in tf.getmembers():
                if m.name.endswith("/words/test.wsj.words.gz"):
                    import gzip
                    words_lines = gzip.decompress(
                        tf.extractfile(m).read()).decode().splitlines()
                elif m.name.endswith("/props/test.wsj.props.gz"):
                    import gzip
                    props_lines = gzip.decompress(
                        tf.extractfile(m).read()).decode().splitlines()
        self.data = self._pair(words_lines, props_lines)

    def _pair(self, words_lines, props_lines):
        """Group by blank-line sentence boundaries; one sample per
        predicate column (the reference's per-verb expansion)."""
        unk = self.word_dict.get("<unk>", 0)
        data = []
        sent, props = [], []
        for w, p in zip(words_lines + [""], props_lines + [""]):
            if not w.strip():
                if sent:
                    cols = list(zip(*[pr.split() for pr in props])) \
                        if props else []
                    verbs = [c[0] for c in zip(*[pr.split()
                                                 for pr in props])] \
                        if props else []
                    n_pred = len(props[0].split()) - 1 if props else 0
                    word_ids = [self.word_dict.get(t.lower(), unk)
                                for t in sent]
                    for k in range(n_pred):
                        labels = [pr.split()[k + 1] for pr in props]
                        lab_ids = [self.label_dict.get(
                            _iob(labels)[i], 0) for i in range(len(labels))]
                        pred_rows = [i for i, pr in enumerate(props)
                                     if pr.split()[0] != "-"]
                        vi = pred_rows[k] if k < len(pred_rows) else 0
                        mark = [1 if i == vi else 0
                                for i in range(len(sent))]
                        data.append((np.array(word_ids),
                                     np.array([vi]), np.array(mark),
                                     np.array(lab_ids)))
                sent, props = [], []
            else:
                sent.append(w.strip())
                props.append(p.strip())
        return data

    def _load_synthetic(self):
        rng = np.random.default_rng(0)
        self.word_dict = {f"w{i}": i for i in range(100)}
        self.verb_dict = {f"v{i}": i for i in range(10)}
        self.label_dict = {f"L{i}": i for i in range(19)}
        self.data = []
        for _ in range(20):
            n = int(rng.integers(5, 15))
            self.data.append((rng.integers(0, 100, n),
                              np.array([int(rng.integers(0, n))]),
                              rng.integers(0, 2, n),
                              rng.integers(0, 19, n)))

    def get_dict(self):
        return self.word_dict, self.verb_dict, self.label_dict

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


def _iob(labels):
    """Convert CoNLL bracket props column to IOB tags (ref conll05.py)."""
    out = []
    cur = None
    for lb in labels:
        tag = "O"
        if lb.startswith("("):
            cur = lb.strip("()*").rstrip(")")
            cur = cur.replace("*", "")
            tag = "B-" + cur
        elif cur is not None:
            tag = "I-" + cur
        if lb.endswith(")"):
            cur = None
        out.append(tag)
    return out


class Movielens(Dataset):
    """MovieLens-1M ratings (ref: text/datasets/movielens.py — parses
    ml-1m.zip: users.dat/movies.dat/ratings.dat, '::'-separated; items are
    (user_id, gender, age, job, movie_id, title_ids, categories, score))."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0, download=True):
        assert mode in ("train", "test")
        if data_file and os.path.exists(data_file):
            self._load_real(data_file)
        else:
            _synthetic_warning("Movielens", "ml-1m.zip")
            self._load_synthetic()
        rng = np.random.default_rng(rand_seed)
        pick = rng.random(len(self._all)) < test_ratio
        self.data = [r for r, t in zip(self._all, pick)
                     if (t if mode == "test" else not t)]

    def _load_real(self, data_file):
        import zipfile
        users, movies = {}, {}
        cats, titles = {}, {}
        with zipfile.ZipFile(data_file) as z:
            base = "ml-1m/"
            for ln in z.read(base + "users.dat").decode(
                    "latin1").splitlines():
                uid, gender, age, job, _zip = ln.split("::")
                users[int(uid)] = (0 if gender == "M" else 1, int(age),
                                  int(job))
            for ln in z.read(base + "movies.dat").decode(
                    "latin1").splitlines():
                mid, title, genres = ln.split("::")
                tids = []
                for w in re.sub(r"\(\d{4}\)", "", title).lower().split():
                    tids.append(titles.setdefault(w, len(titles)))
                gids = [cats.setdefault(g, len(cats))
                        for g in genres.split("|")]
                movies[int(mid)] = (tids, gids)
            self._all = []
            for ln in z.read(base + "ratings.dat").decode(
                    "latin1").splitlines():
                uid, mid, score, _ts = ln.split("::")
                uid, mid = int(uid), int(mid)
                if uid in users and mid in movies:
                    g, a, j = users[uid]
                    tids, gids = movies[mid]
                    self._all.append((np.array([uid]), np.array([g]),
                                      np.array([a]), np.array([j]),
                                      np.array([mid]), np.array(tids),
                                      np.array(gids),
                                      np.array([float(score)], np.float32)))

    def _load_synthetic(self):
        rng = np.random.default_rng(1)
        self._all = []
        for _ in range(200):
            self._all.append((
                rng.integers(1, 100, 1), rng.integers(0, 2, 1),
                rng.integers(1, 56, 1), rng.integers(0, 21, 1),
                rng.integers(1, 200, 1), rng.integers(0, 50, 4),
                rng.integers(0, 18, 2),
                rng.random(1).astype(np.float32) * 5))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


class _WMTBase(Dataset):
    """Shared WMT parser: src/trg parallel text + per-language dicts,
    items (src_ids, trg_ids, trg_ids_next) with <s>/<e>/<unk> specials
    (ref: text/datasets/wmt14.py:203, wmt16.py)."""

    BOS, EOS, UNK = "<s>", "<e>", "<unk>"

    def _build(self, src_lines, trg_lines, src_dict, trg_dict):
        s_unk = src_dict.get(self.UNK, 2)
        t_unk = trg_dict.get(self.UNK, 2)
        bos = trg_dict.get(self.BOS, 0)
        eos = trg_dict.get(self.EOS, 1)
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        for s, t in zip(src_lines, trg_lines):
            si = [src_dict.get(w, s_unk) for w in s.split()]
            ti = [trg_dict.get(w, t_unk) for w in t.split()]
            if not si or not ti:
                continue
            self.src_ids.append(si)
            self.trg_ids.append([bos] + ti)
            self.trg_ids_next.append(ti + [eos])

    def _synthetic(self, vocab=120):
        rng = np.random.default_rng(2)
        self.src_dict = {self.BOS: 0, self.EOS: 1, self.UNK: 2}
        for i in range(vocab):
            self.src_dict[f"w{i}"] = len(self.src_dict)
        self.trg_dict = dict(self.src_dict)
        src = [" ".join(f"w{int(x)}" for x in rng.integers(0, vocab, 8))
               for _ in range(50)]
        trg = [" ".join(f"w{int(x)}" for x in rng.integers(0, vocab, 9))
               for _ in range(50)]
        self._build(src, trg, self.src_dict, self.trg_dict)

    def get_dict(self, reverse=False):
        if reverse:
            return ({v: k for k, v in self.src_dict.items()},
                    {v: k for k, v in self.trg_dict.items()})
        return self.src_dict, self.trg_dict

    def __len__(self):
        return len(self.src_ids)

    def __getitem__(self, i):
        return (np.array(self.src_ids[i]), np.array(self.trg_ids[i]),
                np.array(self.trg_ids_next[i]))


class WMT14(_WMTBase):
    """WMT14 en-fr (ref: text/datasets/wmt14.py — wmt14.tgz with
    train/test dirs of gzipped parallel files + src.dict/trg.dict)."""

    def __init__(self, data_file=None, mode="train", dict_size=30000,
                 download=True):
        assert mode in ("train", "test", "gen")
        if data_file and os.path.exists(data_file):
            self._load_real(data_file, mode, dict_size)
        else:
            _synthetic_warning("WMT14", "wmt14.tgz")
            self._synthetic()

    def _read_dict_lines(self, lines, size):
        d = {}
        for w in lines[:size]:
            w = w.strip()
            if w:
                d[w] = len(d)
        return d

    def _load_real(self, data_file, mode, dict_size):
        import gzip
        split = {"train": "train/", "test": "test/", "gen": "gen/"}[mode]
        src_lines = trg_lines = None
        sdict = tdict = None
        with tarfile.open(data_file) as tf:
            for m in tf.getmembers():
                data = None
                if m.name.endswith("src.dict"):
                    sdict = self._read_dict_lines(
                        tf.extractfile(m).read().decode(
                            "latin1").splitlines(), dict_size)
                elif m.name.endswith("trg.dict"):
                    tdict = self._read_dict_lines(
                        tf.extractfile(m).read().decode(
                            "latin1").splitlines(), dict_size)
                elif split in m.name and m.isfile():
                    raw = tf.extractfile(m).read()
                    if m.name.endswith(".gz"):
                        raw = gzip.decompress(raw)
                    txt = raw.decode("latin1").splitlines()
                    # parallel file: "src\ttrg" per line
                    pairs = [ln.split("\t") for ln in txt if "\t" in ln]
                    src_lines = [p[0] for p in pairs]
                    trg_lines = [p[1] for p in pairs]
        if not (src_lines and sdict and tdict):
            raise ValueError("unrecognized wmt14 archive layout")
        self.src_dict, self.trg_dict = sdict, tdict
        self._build(src_lines, trg_lines, sdict, tdict)


class WMT16(_WMTBase):
    """WMT16 en-de BPE (ref: text/datasets/wmt16.py — wmt16.tar.gz with
    train/val/test parallel files; dicts built from the train corpus with
    specials <s>/<e>/<unk>)."""

    def __init__(self, data_file=None, mode="train", src_dict_size=-1,
                 trg_dict_size=-1, lang="en", download=True):
        assert mode in ("train", "test", "val")
        self.lang = lang
        if data_file and os.path.exists(data_file):
            self._load_real(data_file, mode, src_dict_size, trg_dict_size,
                            lang)
        else:
            _synthetic_warning("WMT16", "wmt16.tar.gz")
            self._synthetic()

    def _load_real(self, data_file, mode, src_sz, trg_sz, lang):
        other = "de" if lang == "en" else "en"
        texts = {}
        with tarfile.open(data_file) as tf:
            for m in tf.getmembers():
                if not m.isfile():
                    continue
                name = os.path.basename(m.name)
                if name in (f"{mode}.tok.bpe.32000.{lang}",
                            f"{mode}.tok.bpe.32000.{other}",
                            f"train.tok.bpe.32000.{lang}",
                            f"train.tok.bpe.32000.{other}"):
                    texts[name] = tf.extractfile(m).read().decode(
                        "utf-8", "ignore").splitlines()
        src_corpus = texts.get(f"train.tok.bpe.32000.{lang}", [])
        trg_corpus = texts.get(f"train.tok.bpe.32000.{other}", [])

        def build_dict(corpus, size):
            freq = collections.Counter(
                w for ln in corpus for w in ln.split())
            d = {self.BOS: 0, self.EOS: 1, self.UNK: 2}
            for w, _ in freq.most_common(None if size < 0 else size - 3):
                d[w] = len(d)
            return d
        self.src_dict = build_dict(src_corpus, src_sz)
        self.trg_dict = build_dict(trg_corpus, trg_sz)
        src_lines = texts.get(f"{mode}.tok.bpe.32000.{lang}", src_corpus)
        trg_lines = texts.get(f"{mode}.tok.bpe.32000.{other}", trg_corpus)
        self._build(src_lines, trg_lines, self.src_dict, self.trg_dict)
