"""Real CLEVR_v1.0 ingestion: extracted zip → chunked HDF5 precompute (port
of `graphax/data/clevr.py`).

The reference downloads CLEVR_v1.0.zip, extracts it, and streams every
image / question through its feature transforms into one HDF5 per split
(`src/data_multi.py:326-428` CLEVR_v1.__init__: datasets ``images
[N, g², feat]``, ``i_graph``, ``questions``, ``image_indices``,
``answers``, ``answers_list``, written chunk by chunk). This mirrors
that layout against the directory the zip extracts to::

    <data_dir>/CLEVR_v1.0/images/<split>/CLEVR_<split>_*.png
    <data_dir>/CLEVR_v1.0/questions/CLEVR_<split>_questions.json

Feature extraction runs through :mod:`graphax_torch.data.extractors`: the
ResNet-101 trunk / HF text embeddings when real checkpoints are staged
(see ``scripts/fetch_data.py``), seeded stand-in projections otherwise.
``PIL`` and ``h5py`` are imported only on the routes that read images or
write and read the HDF5. Graph topology
(the grid / chain edge lists the reference stores per sample as
``i_graph`` / ``q_graph``) is NOT duplicated into the HDF5: graphs are
static per split, rebuilt at load (`multimodal.py`
``batched_chain_graphs`` keeps the per-question variable lengths).

Answer and token vocabularies (the reference's train-split
``answers_list``) live in a JSON sidecar next to the HDF5.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional

import numpy as np

from graphax_torch.data.multimodal import (
    MultimodalGraphDataset, image_grid_graph, text_chain_graph,
)

_TOKEN_RE = re.compile(r"[a-z0-9]+|[;?,!]")


def tokenize(text: str) -> List[str]:
    """Lower-case word/punct tokenizer (stands in for the reference's BERT
    tokenizer when no HF checkpoint is staged)."""
    return _TOKEN_RE.findall(text.lower())


def build_token_vocab(questions: List[dict],
                      max_size: int = 30_000) -> Dict[str, int]:
    """Frequency-ordered token vocabulary from the train questions.
    Index 0 is reserved for PAD/UNK."""
    counts: Dict[str, int] = {}
    for q in questions:
        for tok in tokenize(q["question"]):
            counts[tok] = counts.get(tok, 0) + 1
    ordered = sorted(counts, key=lambda t: (-counts[t], t))[:max_size - 1]
    return {t: i + 1 for i, t in enumerate(ordered)}


def build_answer_vocab(questions: List[dict]) -> List[str]:
    """Sorted unique answers of the train split — the reference's
    ``answers_list`` (`src/data_multi.py:373-384`)."""
    return sorted({str(q["answer"]) for q in questions if "answer" in q})


def _load_image(path: str, side: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((side, side), Image.BILINEAR)
        return np.asarray(im, np.float32) / 255.0


def h5_path(data_dir: str, split: str) -> str:
    # reference naming: CLEVR_v1.0_<split>_norp.h5 (no region proposals)
    return os.path.join(data_dir, f"CLEVR_v1.0_{split}_norp.h5")


def build_clevr_hdf5(data_dir: str, split: str = "train", grid: int = 14,
                     feat_dim: int = 64, text_dim: int = 32,
                     max_question_len: int = 48, batch_size: int = 16,
                     max_images: Optional[int] = None,
                     max_questions: Optional[int] = None,
                     seed: int = 0, device=None) -> str:
    """Stream the extracted CLEVR_v1.0 split into the chunked HDF5 layout
    of the reference precompute. Returns the HDF5 path (reused if it
    already exists). ``max_images`` / ``max_questions`` truncate for
    smoke runs; ``device`` runs a staged ResNet trunk (the card unless
    asked otherwise)."""
    import h5py

    from graphax_torch.data.extractors import (ImageFeatureExtractor,
                                               TextFeatureExtractor)

    out = h5_path(data_dir, split)
    if os.path.exists(out):
        return out
    root = os.path.join(data_dir, "CLEVR_v1.0")
    img_dir = os.path.join(root, "images", split)
    q_file = os.path.join(root, "questions",
                          f"CLEVR_{split}_questions.json")
    if not os.path.isdir(img_dir) or not os.path.exists(q_file):
        raise FileNotFoundError(
            f"CLEVR_v1.0 raw data not found under {root} — stage it with "
            "scripts/fetch_data.py --only clevr (or unzip CLEVR_v1.0.zip "
            "there)")

    img_ex = ImageFeatureExtractor(feat_dim, grid=grid, data_dir=data_dir,
                                   seed=seed, device=device)
    txt_ex = TextFeatureExtractor(text_dim, vocab_size=30_000,
                                  data_dir=data_dir, seed=seed)
    side = grid * 16 if img_ex.using_real_weights else grid

    images_list = sorted(
        os.path.join(img_dir, f) for f in os.listdir(img_dir)
        if f.endswith(".png"))
    if max_images is not None:
        images_list = images_list[:max_images]
    if not images_list:
        raise FileNotFoundError(f"no .png images under {img_dir} "
                                "(empty split or max_images=0)")
    with open(q_file) as f:
        questions = json.load(f)["questions"]
    if max_images is not None:
        questions = [q for q in questions
                     if q["image_index"] < len(images_list)]
    if max_questions is not None:
        questions = questions[:max_questions]

    # vocabularies come from the TRAIN split; other splits must reuse them
    # (a val-built answer vocab silently permutes class indices whenever
    # the answer sets differ — `src/data_multi.py:373-384` likewise builds
    # answers_list only on train)
    if split == "train":
        token_vocab = build_token_vocab(questions)
        answer_list = build_answer_vocab(questions)
    else:
        train_sidecar = h5_path(data_dir, "train") + ".vocab.json"
        if os.path.exists(train_sidecar):
            with open(train_sidecar) as f:
                voc = json.load(f)
            token_vocab, answer_list = voc["tokens"], voc["answers"]
        else:
            # no precomputed train HDF5 yet: build the vocab from the raw
            # train questions file directly so indices stay train-anchored
            train_q = os.path.join(root, "questions",
                                   "CLEVR_train_questions.json")
            if not os.path.exists(train_q):
                raise FileNotFoundError(
                    f"cannot build the '{split}' split before a train "
                    "vocabulary exists: build the train split first or "
                    f"stage {train_q}")
            with open(train_q) as f:
                tq = json.load(f)["questions"]
            token_vocab = build_token_vocab(tq)
            answer_list = build_answer_vocab(tq)
    answer_idx = {a: i for i, a in enumerate(answer_list)}

    n_img, n_q = len(images_list), len(questions)
    tmp = out + ".tmp"
    with h5py.File(tmp, "w") as f:
        f.create_dataset("images", (n_img, grid * grid, feat_dim),
                         chunks=(min(batch_size, n_img), grid * grid,
                                 feat_dim), dtype="float32")
        for s in range(0, n_img, batch_size):
            batch = images_list[s:s + batch_size]
            raw = np.stack([_load_image(p, side) for p in batch])
            f["images"][s:s + len(batch)] = np.asarray(
                img_ex(raw), np.float32)

        f.create_dataset("questions", (n_q, max_question_len, text_dim),
                         chunks=(min(batch_size, max(n_q, 1)),
                                 max_question_len, text_dim),
                         dtype="float32")
        f.create_dataset("image_indices", (n_q,), dtype="int32")
        f.create_dataset("question_lengths", (n_q,), dtype="int32")
        has_answers = n_q > 0 and "answer" in questions[0]
        if has_answers:
            f.create_dataset("answers", (n_q,), dtype="int32")
        for s in range(0, n_q, batch_size):
            batch = questions[s:s + batch_size]
            ids = np.zeros((len(batch), max_question_len), np.int64)
            lens = np.zeros((len(batch),), np.int32)
            for bi, q in enumerate(batch):
                toks = tokenize(q["question"])[:max_question_len]
                lens[bi] = max(len(toks), 1)
                for ti, t in enumerate(toks):
                    ids[bi, ti] = token_vocab.get(t, 0)
            feats = np.asarray(txt_ex(ids), np.float32)
            pad = np.arange(max_question_len)[None, :] >= lens[:, None]
            f["questions"][s:s + len(batch)] = \
                np.where(pad[:, :, None], 0.0, feats)
            f["image_indices"][s:s + len(batch)] = \
                [q["image_index"] for q in batch]
            f["question_lengths"][s:s + len(batch)] = lens
            if has_answers:
                f["answers"][s:s + len(batch)] = \
                    [answer_idx.get(str(q["answer"]), 0) for q in batch]
        f.attrs["grid"] = grid
        f.attrs["num_classes"] = len(answer_list)
    with open(out + ".vocab.json", "w") as f:
        json.dump({"tokens": token_vocab, "answers": answer_list}, f)
    os.replace(tmp, out)
    return out


@dataclasses.dataclass(frozen=True)
class ClevrDataset(MultimodalGraphDataset):
    """CLEVR split where several questions share one image: ``images`` is
    deduplicated ``[N_img, g², feat]`` and ``image_indices`` maps each
    question to its image, exactly the reference's ``__getitem__``
    indirection (`src/data_multi.py:404-410`)."""

    image_indices: Optional[np.ndarray] = None

    def __getitem__(self, i):
        # NOT super().__getitem__: the base class indexes images by the
        # SAMPLE index, which for CLEVR runs past the deduplicated image
        # array as soon as i >= n_images (several questions per image)
        tg = self._text_graph(i)
        return {
            "modality_data": [
                np.asarray(self.images[int(self.image_indices[i])]),
                np.asarray(self.questions[int(i)]),
            ],
            "modality_graphs": [self.image_graph, tg],
            "additional_data": None,
            "labels": self.answers[int(i)],
        }

    @staticmethod
    def _take(arr, sel):
        """Fancy-index ``arr`` by an UNSORTED index array, supporting both
        numpy arrays and h5py datasets (which require sorted unique
        indices: read the sorted uniques, then re-expand)."""
        if isinstance(arr, np.ndarray):
            return arr[sel]
        uniq, inv = np.unique(np.asarray(sel), return_inverse=True)
        return np.asarray(arr[uniq])[inv]

    def batches(self, batch_size: int, seed: int = 0):
        idx = np.random.RandomState(seed).permutation(len(self))
        for s in range(0, len(self) - batch_size + 1, batch_size):
            sel = idx[s:s + batch_size]
            yield (self._take(self.images, self.image_indices[sel]),
                   self._take(self.questions, sel),
                   self.answers[sel], sel)


def load_clevr(data_dir: str, split: str = "train",
               build_kwargs: Optional[dict] = None,
               lazy: Optional[bool] = None, device=None) -> ClevrDataset:
    """Load (building the HDF5 precompute on first use) a real CLEVR
    split as a :class:`ClevrDataset`.

    ``lazy``: keep the big per-sample arrays (images, questions) as open
    h5py datasets and read them batch-wise — the point of the chunked
    layout; real CLEVR train at the defaults is ~8 GB materialized.
    Default: lazy for splits over ~1 GB, eager below (fixture-sized
    splits train faster from RAM). The small per-question tables
    (indices, lengths, answers) always load eagerly. The graphs go on
    ``device`` (the card unless asked otherwise)."""
    import h5py

    path = build_clevr_hdf5(data_dir, split, device=device,
                            **(build_kwargs or {}))
    f = h5py.File(path, "r")
    image_indices = f["image_indices"][:].astype(np.int64)
    q_lens = f["question_lengths"][:].astype(np.int64)
    answers = (f["answers"][:].astype(np.int64) if "answers" in f
               else np.zeros(len(image_indices), np.int64))
    grid = int(f.attrs["grid"])
    num_classes = int(f.attrs["num_classes"])
    big_bytes = f["images"].nbytes + f["questions"].nbytes
    if lazy is None:
        lazy = big_bytes > 1 << 30
    if lazy:
        images, questions = f["images"], f["questions"]   # h5py-backed
    else:
        images = np.asarray(f["images"][:], np.float32)
        questions = np.asarray(f["questions"][:], np.float32)
        f.close()
    return ClevrDataset(
        image_graph=image_grid_graph(grid, device),
        text_graph=text_chain_graph(questions.shape[1], device),
        images=images, questions=questions,
        answers=answers, num_classes=max(num_classes, 1),
        question_lengths=q_lens, image_indices=image_indices)
