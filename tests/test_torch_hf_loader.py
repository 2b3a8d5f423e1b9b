"""The port's indexable-dataset loader against the JAX package's, on the CPU.

- ``HfDatasetLoader`` yields the JAX loader's exact index batches (the
  collate returns the fetched items) for several seeds, intervals, world
  sizes and ranks, in train (shuffled per interval, full batches) and eval
  (dataset order, final partial batch); ``len()`` agrees;
- corrupt samples: train batches are backfilled with the same replacement
  indices, eval batches drop them; a dataset with nothing readable raises;
- a batch the collate returns as ``None`` (an all-unreadable RVL-CDIP eval
  batch) ends the JAX loader's epoch early, and reaches the port's
  consumer as ``None``;
- ``SafeDataset``, ``CustomVQADataset`` over a tmp directory in each of its
  three layouts, ``get_additional_tokens_from_dataset`` and the
  ``hf_dataset`` branch of ``create_loader`` (``SinglePageDocVQA`` through
  ``PIXPARSE_DOCVQA_DIR``).
"""

import json

import numpy as np
import pytest
from PIL import Image

from pixparse_tpu.data import datasets_utils as jax_du
from pixparse_tpu.data.loader import HfDatasetLoader as JaxLoader
from pixparse_tpu_torch.data import datasets_utils as du
from pixparse_tpu_torch.data.config import DatasetCfg
from pixparse_tpu_torch.data.loader import HfDatasetLoader, create_loader
from pixparse_tpu_torch.task.common import SPECIAL_TOKENS_FROM_PRETRAIN


def _items(items):
    return list(items)


def _both(dataset, **kw):
    kw.setdefault("num_workers", 2)
    got = HfDatasetLoader(dataset, collate_fn=_items, **kw)
    want = JaxLoader(dataset, collate_fn=_items, **kw)
    return got, want


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("seed", [0, 7, 42])
@pytest.mark.parametrize("interval", [0, 3])
@pytest.mark.parametrize("world_size", [1, 2, 3])
def test_index_batches_equal_to_jax(is_train, seed, interval, world_size):
    dataset = list(range(23))
    for rank in range(world_size):
        got, want = _both(dataset, batch_size=4, is_train=is_train, seed=seed,
                          world_size=world_size, global_rank=rank)
        got.set_interval(interval)
        want.set_interval(interval)
        batches = list(got)
        assert batches == list(want)
        assert len(got) == len(want) == len(batches)
        assert batches == got.batch_indices()  # nothing corrupt: the plan is what came
        if is_train:
            assert all(len(b) == 4 for b in batches)
        else:
            assert sorted(sum(batches, [])) == list(range(rank, 23, world_size))


class _Corrupt:
    """Items are their indices; the listed ones raise (a corrupt file)."""

    def __init__(self, n, bad):
        self.n, self.bad = n, set(bad)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i in self.bad:
            raise OSError(f"corrupt sample {i}")
        return i


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("seed", [0, 5])
def test_corrupt_samples_backfilled_like_jax(is_train, seed):
    bad = [1, 4, 5, 9, 13, 14, 15]
    got, want = _both(du.SafeDataset(_Corrupt(20, bad)), batch_size=4, is_train=is_train,
                      seed=seed, num_workers=1)
    got.set_interval(2)
    want.set_interval(2)
    jgot = JaxLoader(jax_du.SafeDataset(_Corrupt(20, bad)), collate_fn=_items, batch_size=4,
                     is_train=is_train, seed=seed, num_workers=1)
    jgot.set_interval(2)
    batches = list(got)
    assert batches == list(want) == list(jgot)
    flat = sum(batches, [])
    assert not set(flat) & set(bad)
    if is_train:
        assert all(len(b) == 4 for b in batches)
    else:
        assert sorted(flat) == sorted(set(range(20)) - set(bad))


def test_unreadable_train_dataset_raises_in_the_consumer():
    loader = HfDatasetLoader(du.SafeDataset(_Corrupt(8, range(8))), 2, _items, is_train=True,
                             num_workers=1)
    with pytest.raises(RuntimeError, match="backfill"):
        list(loader)


def test_collate_error_raises_in_the_consumer():
    def collate(items):
        if 4 in items:
            raise ValueError("bad batch")
        return items

    loader = HfDatasetLoader(list(range(8)), 2, collate, is_train=False, num_workers=1)
    it = iter(loader)
    assert next(it) == [0, 1] and next(it) == [2, 3]
    with pytest.raises(ValueError, match="bad batch"):
        next(it)


def test_a_none_batch_ends_the_jax_epoch_but_not_the_ports():
    """The JAX loader's end mark is ``None``, which is also what the
    RVL-CDIP eval collate returns for a batch of unreadable pages: such a
    batch silently ends its epoch. The port's end mark is private."""
    def collate(items):
        return None if items == [2, 3] else items

    want = JaxLoader(list(range(8)), 2, collate, is_train=False, num_workers=1)
    got = HfDatasetLoader(list(range(8)), 2, collate, is_train=False, num_workers=1)
    assert len(want) == len(got) == 4
    assert list(want) == [[0, 1]]
    assert list(got) == [[0, 1], None, [4, 5], [6, 7]]


def test_safe_dataset_like_jax():
    inner = _Corrupt(6, [2])
    got, want = du.SafeDataset(inner), jax_du.SafeDataset(inner)
    assert len(got) == len(want) == 6
    assert [got[i] for i in range(6)] == [want[i] for i in range(6)] == [0, 1, None, 3, 4, 5]


def _png(path, seed, size=(80, 60)):
    rng = np.random.RandomState(seed)
    Image.fromarray(rng.randint(0, 255, size, np.uint8), "L").save(path)


RAW = [
    {"image": "documents/a.png", "question": "what is the date?", "answers": ["1 May", "May 1"],
     "questionId": 11},
    {"image": "documents/a.png", "question": "who?", "answers": ["Ann"], "questionId": 12},
    {"image": "documents/b.png", "question": "total?", "answers": [], "questionId": 13},
]


def _docvqa_dir(root, layout):
    """``flat``: root/{split}_v1.0.json lists; ``nested``: root/{split}/
    {split}_v1.0.json with a ``data`` key; ``processed``: the train split as
    root/train/processed_train_v1.0.json, ``{image: [qa strings]}``."""
    for split in ("train", "val", "test"):
        base = root if layout == "flat" else root / split
        (base / "documents").mkdir(parents=True, exist_ok=True)
        for i, name in enumerate(("a", "b")):
            _png(base / "documents" / f"{name}.png", i)
        if layout == "processed" and split == "train":
            anno = {"documents/a.png": ["<s_question>q1</s_question><s_answer>a1</s_answer>"],
                    "documents/b.png": ["<s_question>q2</s_question><s_answer>a2</s_answer>",
                                        "<s_question>q3</s_question><s_answer>a3</s_answer>"]}
            (base / "processed_train_v1.0.json").write_text(json.dumps(anno))
        elif layout == "flat":
            (base / f"{split}_v1.0.json").write_text(json.dumps(RAW))
        else:
            (base / f"{split}_v1.0.json").write_text(json.dumps({"data": RAW}))
    return str(root)


@pytest.mark.parametrize("layout", ["flat", "nested", "processed"])
def test_custom_vqa_dataset_like_jax(tmp_path, layout):
    root = _docvqa_dir(tmp_path, layout)
    for split in ("train", "val", "test"):
        got, want = du.CustomVQADataset(root, split), jax_du.CustomVQADataset(root, split)
        assert got.entries == want.entries and len(got) == len(want) > 0
        for i in range(len(got)):
            g, w = got[i], want[i]
            assert {k: v for k, v in g.items() if k != "image"} == {
                k: v for k, v in w.items() if k != "image"}
            assert np.array_equal(np.asarray(g["image"]), np.asarray(w["image"]))
    with pytest.raises(FileNotFoundError):
        du.CustomVQADataset(str(tmp_path / "missing"), "val")


def test_additional_tokens_from_dataset_like_jax():
    rng = np.random.RandomState(0)
    dataset = [{"ground_truth": str({"gt_parse": {"menu": [{"nm": f"x{i}", "price": str(i)}],
                                                  "total": {"cashprice": "1"}}})}
               for i in range(3)]
    dataset.append({"ground_truth": {"gt_parses": [{"sub_total": {"tax_price": "2"}},
                                                   {"void_menu": str(rng.randint(9))}]}})
    got = du.get_additional_tokens_from_dataset(SPECIAL_TOKENS_FROM_PRETRAIN, dataset)
    assert got == jax_du.get_additional_tokens_from_dataset(SPECIAL_TOKENS_FROM_PRETRAIN, dataset)
    assert "<s_tax_price>" in got and "</s_void_menu>" in got
    assert du.get_additional_tokens_from_dataset([], dataset, dataset_id="other") is None


def test_create_loader_hf_dataset_docvqa(tmp_path, monkeypatch):
    monkeypatch.setenv("PIXPARSE_DOCVQA_DIR", _docvqa_dir(tmp_path, "nested"))
    cfg = DatasetCfg(source="SinglePageDocVQA", num_samples=3, batch_size=2, split="val",
                     format="hf_dataset", num_workers=1)
    bundle = create_loader(cfg, is_train=False, collate_fn=_items)
    assert (bundle.num_batches, bundle.num_samples) == (2, 3)
    batches = list(bundle.loader)
    assert [len(b) for b in batches] == [2, 1]
    assert [b["question_id"] for b in sum(batches, [])] == [11, 12, 13]
    assert batches[0][0]["labels"] == {"question": "what is the date?",
                                       "answers": ["1 May", "May 1"]}
    train = DatasetCfg(source="SinglePageDocVQA", num_samples=2, batch_size=1, split="train",
                       format="hf_dataset", num_workers=1)
    bundle = create_loader(train, is_train=True, collate_fn=_items, seed=3)
    assert bundle.num_batches == 2  # two images, one entry each with all their Q&As
    assert sorted(len(b[0]["labels"]) for b in bundle.loader) == [1, 2]
