"""``paddle.text.datasets`` (counterpart of
``paddle_tpu/text/datasets.py``): ``UCIHousing``, ``Imdb``,
``Movielens``, ``Conll05st``, ``Imikolov``, ``WMT14``, ``WMT16``, and
``ViterbiDecoder`` / ``viterbi_decode``.

Each dataset reads the archive or file the reference downloads, given
as ``data_file=`` (nothing downloads: without one it raises the JAX
package's message), and parses it as the JAX package does, on the host,
into numpy samples (``Movielens`` splits with ``default_rng(rand_seed)``
as there). ``viterbi_decode`` runs on the potentials' device: an eager
loop over the steps in the JAX ``lax.scan``'s order, its first-index
``argmax`` ties, its ``lengths`` masking (a padded step keeps its
scores and points back to itself) and ``include_bos_eos_tag`` (the last
two tags are BOS and EOS: the start adds ``trans[BOS]``, the end
``trans[:, EOS]``). It returns ``(scores [B], paths [B, T] int64)``.
"""
from __future__ import annotations

import collections
import gzip
import os
import re
import tarfile
import zipfile
from typing import List

import numpy as np
import torch

from ..core.tensor import to_tensor_arg
from ..io.dataloader import Dataset

__all__ = ["UCIHousing", "Imdb", "Movielens", "Conll05st", "ViterbiDecoder",
           "viterbi_decode", "Imikolov", "WMT14", "WMT16"]


def _need_file(data_file, name, url_hint):
    if data_file is None or not os.path.exists(data_file or ""):
        raise RuntimeError(
            f"{name}: no network egress in this environment — pass "
            f"data_file= pointing at the reference archive ({url_hint})")
    return data_file


class UCIHousing(Dataset):
    """506x13 housing regression (reference ``uci_housing.py``). Feature
    normalization matches the reference: per-column max/min/avg computed
    over the FULL dataset, then split 80/20."""

    TRAIN_RATIO = 0.8

    def __init__(self, data_file=None, mode="train", download=False):
        data_file = _need_file(data_file, "UCIHousing",
                               "uci_housing/housing.data")
        raw = np.loadtxt(data_file).astype("float32")
        if raw.ndim != 2 or raw.shape[1] != 14:
            raise ValueError("housing.data must be [N, 14]")
        feats = raw[:, :-1]
        mx, mn, avg = feats.max(0), feats.min(0), feats.mean(0)
        denom = np.where(mx - mn == 0, 1, mx - mn)
        feats = (feats - avg) / denom
        data = np.concatenate([feats, raw[:, -1:]], axis=1)
        n_train = int(len(raw) * self.TRAIN_RATIO)
        self.data = data[:n_train] if mode == "train" else data[n_train:]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        row = self.data[idx]
        return row[:-1].astype("float32"), row[-1:].astype("float32")


class Imdb(Dataset):
    """IMDB sentiment (reference ``imdb.py``): parses the aclImdb tarball,
    builds a frequency-cutoff word dict, yields (ids, label)."""

    def __init__(self, data_file=None, mode="train", cutoff=150,
                 download=False):
        data_file = _need_file(data_file, "Imdb", "aclImdb_v1.tar.gz")
        self._pattern = re.compile(rf"aclImdb/{mode}/(pos|neg)/.*\.txt$")
        # single archive pass: tokenize once, reuse for dict + split load
        self._tokens_cache = {}
        self.word_idx = self._build_word_dict(data_file, cutoff)
        self.docs, self.labels = self._load(data_file)
        del self._tokens_cache

    @staticmethod
    def _tokenize(text: str) -> List[str]:
        return text.strip().lower().replace("<br />", " ").translate(
            str.maketrans("", "", "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")
        ).split()

    def _iter_docs(self, tar_path, pattern):
        cached = getattr(self, "_tokens_cache", None)
        if cached:
            for name, words in cached.items():
                if pattern.match(name):
                    yield name, words
            return
        with tarfile.open(tar_path) as tf:
            for member in tf.getmembers():
                if pattern.match(member.name):
                    f = tf.extractfile(member)
                    if f is not None:
                        words = self._tokenize(
                            f.read().decode("utf-8", "ignore"))
                        if cached is not None:
                            cached[member.name] = words
                        yield member.name, words

    def _build_word_dict(self, tar_path, cutoff):
        freq = {}
        pat = re.compile(r"aclImdb/(train|test)/(pos|neg)/.*\.txt$")
        for _name, words in self._iter_docs(tar_path, pat):
            for w in words:
                freq[w] = freq.get(w, 0) + 1
        words = [(w, c) for w, c in freq.items() if c > cutoff]
        words.sort(key=lambda t: (-t[1], t[0]))
        word_idx = {w: i for i, (w, _c) in enumerate(words)}
        word_idx["<unk>"] = len(word_idx)
        return word_idx

    def _load(self, tar_path):
        unk = self.word_idx["<unk>"]
        docs, labels = [], []
        for name, words in self._iter_docs(tar_path, self._pattern):
            docs.append(np.asarray(
                [self.word_idx.get(w, unk) for w in words], np.int64))
            labels.append(0 if "/pos/" in name else 1)
        return docs, np.asarray(labels, np.int64)

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]


class Movielens(Dataset):
    """MovieLens-1M ratings (reference ``movielens.py``): yields
    (user_id, gender, age, job, movie_id, category_ids, title_ids, rating)."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0, download=False):
        data_file = _need_file(data_file, "Movielens", "ml-1m.zip")
        movies: dict = {}
        categories: dict = {}
        titles: dict = {}
        with zipfile.ZipFile(data_file) as zf:
            base = next(n for n in zf.namelist() if n.endswith("movies.dat"))
            root = os.path.dirname(base)
            with zf.open(f"{root}/movies.dat") as f:
                for line in f.read().decode("latin1").splitlines():
                    mid, title, cats = line.strip().split("::")
                    for c in cats.split("|"):
                        categories.setdefault(c, len(categories))
                    title_words = title.lower().split()
                    for w in title_words:
                        titles.setdefault(w, len(titles))
                    movies[int(mid)] = (
                        [categories[c] for c in cats.split("|")],
                        [titles[w] for w in title_words])
            users = {}
            with zf.open(f"{root}/users.dat") as f:
                for line in f.read().decode("latin1").splitlines():
                    uid, gender, age, job, _zip = line.strip().split("::")
                    users[int(uid)] = (0 if gender == "M" else 1,
                                       int(age), int(job))
            rows = []
            with zf.open(f"{root}/ratings.dat") as f:
                for line in f.read().decode("latin1").splitlines():
                    uid, mid, rating, _ts = line.strip().split("::")
                    rows.append((int(uid), int(mid), float(rating)))
        rng = np.random.default_rng(rand_seed)
        mask = rng.random(len(rows)) < test_ratio
        keep = [r for r, m in zip(rows, mask) if m == (mode == "test")]
        self._samples = []
        for uid, mid, rating in keep:
            if mid not in movies or uid not in users:
                continue
            g, a, j = users[uid]
            cats, tw = movies[mid]
            self._samples.append((uid, g, a, j, mid,
                                  np.asarray(cats, np.int64),
                                  np.asarray(tw, np.int64),
                                  np.float32(rating)))
        self.categories_dict = categories
        self.movie_title_dict = titles

    def __len__(self):
        return len(self._samples)

    def __getitem__(self, idx):
        return self._samples[idx]


class Conll05st(Dataset):
    """CoNLL-2005 SRL (reference ``conll05.py``): yields word/predicate/
    context/mark id sequences + label ids. Expects the reference's
    test.wsj tarball + word/verb/target dict files."""

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, mode="test",
                 download=False):
        data_file = _need_file(data_file, "Conll05st", "conll05st-tests.tar.gz")
        self.word_dict = self._load_dict(_need_file(
            word_dict_file, "Conll05st", "wordDict.txt"))
        self.predicate_dict = self._load_dict(_need_file(
            verb_dict_file, "Conll05st", "verbDict.txt"))
        self.label_dict = self._load_label_dict(_need_file(
            target_dict_file, "Conll05st", "targetDict.txt"))
        self._samples = self._parse(data_file)

    @staticmethod
    def _load_dict(path):
        out = {}
        with open(path) as f:
            for i, line in enumerate(f):
                out[line.strip()] = i
        return out

    @staticmethod
    def _load_label_dict(path):
        out = {}
        with open(path) as f:
            for line in f:
                w = line.strip()
                if w.startswith("B-"):
                    out[w[2:]] = len(out)
        return out

    def _parse(self, tar_path):
        sentences = []
        words_file = props_file = None
        with tarfile.open(tar_path) as tf:
            for m in tf.getmembers():
                if m.name.endswith(".words.gz"):
                    words_file = gzip.decompress(tf.extractfile(m).read())
                elif m.name.endswith(".props.gz"):
                    props_file = gzip.decompress(tf.extractfile(m).read())
        if words_file is None or props_file is None:
            raise ValueError("archive lacks .words.gz/.props.gz members")
        word_lines = words_file.decode().splitlines()
        prop_lines = props_file.decode().splitlines()
        unk = self.word_dict.get("<unk>", 0)
        sent, props = [], []
        for wl, pl in zip(word_lines, prop_lines):
            if wl.strip():
                sent.append(wl.strip())
                props.append(pl.split())
            else:
                if sent:
                    sentences.extend(self._make_samples(sent, props, unk))
                sent, props = [], []
        if sent:
            sentences.extend(self._make_samples(sent, props, unk))
        return sentences

    def _labels_for(self, props, k):
        """Parse the k-th predicate's bracketed props column into B-/I-/O
        label ids (reference conll05 label scheme)."""
        ids = []
        cur = None
        for p in props:
            tok = p[k + 1]
            if tok.startswith("("):
                cur = tok[1:].split("*")[0].rstrip(")")
                ids.append(self.label_dict.get(cur, len(self.label_dict)) * 2)
            elif cur is not None:
                ids.append(self.label_dict.get(cur, len(self.label_dict)) * 2 + 1)
            else:
                ids.append(2 * len(self.label_dict))  # O
            if tok.endswith(")"):
                cur = None
        return np.asarray(ids, np.int64)

    def _make_samples(self, words, props, unk):
        """Reference sample shape: (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1,
        ctx_p2, pred_id, mark, label_ids) — 5 context windows around the
        predicate position."""
        out = []
        n_preds = len(props[0]) - 1 if props and len(props[0]) > 1 else 0
        word_ids = np.asarray(
            [self.word_dict.get(w.lower(), unk) for w in words], np.int64)
        T = len(words)
        for k in range(n_preds):
            pred_pos = next((i for i, p in enumerate(props)
                             if p[k + 1].startswith("(V")), None)
            if pred_pos is None:
                continue
            pred = props[pred_pos][0]
            if pred not in self.predicate_dict:
                continue
            pred_id = self.predicate_dict[pred]
            mark = np.asarray([1 if p[k + 1].startswith("(V") else 0
                               for p in props], np.int64)
            ctx = []
            for off in (-2, -1, 0, 1, 2):
                j = min(max(pred_pos + off, 0), T - 1)
                ctx.append(np.full(T, word_ids[j], np.int64))
            labels = self._labels_for(props, k)
            out.append((word_ids, *ctx, np.int64(pred_id), mark, labels))
        return out

    def __len__(self):
        return len(self._samples)

    def __getitem__(self, idx):
        return self._samples[idx]


class ViterbiDecoder:
    """CRF Viterbi decoding with fixed ``transitions``."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        self._trans = transitions
        self._tags = include_bos_eos_tag

    def __call__(self, potentials, lengths):
        return viterbi_decode(potentials, self._trans, lengths, self._tags)


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """Best tag paths of emission ``potentials [B, T, N]`` under
    ``transition_params [N, N]`` (see the module docstring)."""
    pot = to_tensor_arg(potentials)
    trans = to_tensor_arg(transition_params).to(pot.device)
    lens = to_tensor_arg(lengths).to(pot.device)
    B, T, N = pot.shape
    score = pot[:, 0]
    if include_bos_eos_tag:
        score = score + trans[N - 2][None, :]
    tags = torch.arange(N, device=pot.device).expand(B, N)
    backs = []
    for t in range(1, T):
        cand = score[:, :, None] + trans[None] + pot[:, t][:, None, :]
        new, back = cand.max(dim=1)
        active = (t < lens)[:, None]
        score = torch.where(active, new, score)
        backs.append(torch.where(active, back, tags))
    if include_bos_eos_tag:
        score = score + trans[:, N - 1][None, :]
    best, last = score.max(dim=-1)
    path = [last]
    for back in reversed(backs):
        path.append(back.gather(1, path[-1][:, None])[:, 0])
    return best, torch.stack(path[::-1], dim=1)


class Imikolov(Dataset):
    """PTB n-gram/seq dataset (reference ``imikolov.py``): builds the word
    dict from the train split with frequency cutoff, yields n-grams
    (data_type='NGRAM') or full sequences ('SEQ')."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=-1,
                 mode="train", min_word_freq=50, download=False):
        data_file = _need_file(data_file, "Imikolov",
                               "simple-examples.tgz")
        if data_type == "NGRAM" and window_size < 1:
            raise ValueError("NGRAM needs window_size >= 2")
        split = {"train": "ptb.train.txt", "test": "ptb.valid.txt"}[mode]
        with tarfile.open(data_file) as tf:
            def read(name):
                for m in tf.getmembers():
                    if m.name.endswith(name):
                        return tf.extractfile(m).read().decode().splitlines()
                raise ValueError(f"{name} not in archive")

            train_lines = read("ptb.train.txt")
            lines = train_lines if mode == "train" else read(split)
        freq = collections.Counter(
            w for l in train_lines for w in l.strip().split())
        words = sorted([w for w, c in freq.items() if c >= min_word_freq])
        self.word_idx = {w: i for i, w in enumerate(words)}
        self.word_idx["<unk>"] = len(self.word_idx)
        self.word_idx["<e>"] = len(self.word_idx)
        unk = self.word_idx["<unk>"]
        self.data = []
        for l in lines:
            ids = [self.word_idx.get(w, unk) for w in l.strip().split()]
            ids = ids + [self.word_idx["<e>"]]
            if data_type == "NGRAM":
                for i in range(len(ids) - window_size + 1):
                    self.data.append(
                        np.asarray(ids[i:i + window_size], np.int64))
            else:
                self.data.append(np.asarray(ids, np.int64))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]


class _WMTBase(Dataset):
    """Shared WMT loader: token-id pairs (src, trg, trg_next) from the
    preprocessed archives the reference ships (wmt14.py / wmt16.py)."""

    BOS, EOS, UNK = 0, 1, 2

    def __init__(self, data_file, name, mode, dict_size, src_lines,
                 trg_lines, src_dict, trg_dict):
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        for s, t in zip(src_lines, trg_lines):
            sids = [src_dict.get(w, self.UNK) for w in s.strip().split()]
            tids = [trg_dict.get(w, self.UNK) for w in t.strip().split()]
            self.src_ids.append(np.asarray(sids, np.int64))
            self.trg_ids.append(
                np.asarray([self.BOS] + tids, np.int64))
            self.trg_ids_next.append(
                np.asarray(tids + [self.EOS], np.int64))
        self._src_dict = src_dict
        self._trg_dict = trg_dict

    def __len__(self):
        return len(self.src_ids)

    def __getitem__(self, idx):
        return (self.src_ids[idx], self.trg_ids[idx],
                self.trg_ids_next[idx])

    def get_dict(self, lang="en", reverse=False):
        d = self._src_dict if lang == "en" else self._trg_dict
        if reverse:
            return {v: k for k, v in d.items()}
        return dict(d)


def _build_dict(lines, dict_size):
    freq = collections.Counter(w for l in lines for w in l.strip().split())
    words = [w for w, _ in freq.most_common(max(dict_size - 3, 0))]
    d = {"<s>": 0, "<e>": 1, "<unk>": 2}
    for w in words:
        d[w] = len(d)
    return d


class WMT14(_WMTBase):
    """WMT14 en->fr (reference ``wmt14.py``): expects the dev+train tgz
    with plain-text parallel files ``*.src``/``*.trg`` per split."""

    def __init__(self, data_file=None, mode="train", dict_size=-1,
                 download=False):
        data_file = _need_file(data_file, "WMT14", "wmt14 dev+train tgz")
        if dict_size < 3:
            raise ValueError("dict_size must be >= 3")
        pat = {"train": "train/", "test": "test/", "gen": "gen/"}[mode]
        src_lines, trg_lines = [], []
        with tarfile.open(data_file) as tf:
            names = [m.name for m in tf.getmembers() if pat in m.name]
            for n in sorted(names):
                if n.endswith(".src"):
                    src_lines += tf.extractfile(n).read().decode().splitlines()
                elif n.endswith(".trg"):
                    trg_lines += tf.extractfile(n).read().decode().splitlines()
        src_dict = _build_dict(src_lines, dict_size)
        trg_dict = _build_dict(trg_lines, dict_size)
        super().__init__(data_file, "WMT14", mode, dict_size, src_lines,
                         trg_lines, src_dict, trg_dict)


class WMT16(_WMTBase):
    """WMT16 en<->de (reference ``wmt16.py``): the tarball layout is
    ``wmt16/{train,val,test}.{en,de}`` plain-text pairs."""

    def __init__(self, data_file=None, mode="train", src_dict_size=-1,
                 trg_dict_size=-1, lang="en", download=False):
        data_file = _need_file(data_file, "WMT16", "wmt16.tar.gz")
        split = {"train": "train", "test": "test", "val": "val"}[mode]
        other = "de" if lang == "en" else "en"
        with tarfile.open(data_file) as tf:
            def read(suffix):
                for m in tf.getmembers():
                    if m.name.endswith(f"{split}.{suffix}"):
                        return tf.extractfile(m).read().decode().splitlines()
                raise ValueError(f"{split}.{suffix} missing")

            src_lines = read(lang)
            trg_lines = read(other)
        src_dict = _build_dict(src_lines, src_dict_size)
        trg_dict = _build_dict(trg_lines, trg_dict_size)
        super().__init__(data_file, "WMT16", mode, src_dict_size, src_lines,
                         trg_lines, src_dict, trg_dict)
