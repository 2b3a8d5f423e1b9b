"""HF-dataset helpers (counterpart of :mod:`pixparse_tpu.data.datasets_utils`).

- :class:`CustomVQADataset`: local SinglePageDocVQA layout (train: one entry
  per image with all Q&As; val/test: one entry per question with question_id).
- :class:`SafeDataset`: corrupt-sample tolerance: ``__getitem__`` returns
  None instead of raising (the loader backfills train batches, the eval
  collates drop them).
- :func:`get_additional_tokens_from_dataset`: one-pass scan deriving the
  ``<s_key>``-style special tokens a JSON dataset needs (CORD protocol).
"""

from __future__ import annotations

import json
import logging
import os
from ast import literal_eval
from typing import List, Optional

from pixparse_tpu_torch.utils.json_utils import json2token

_logger = logging.getLogger(__name__)


class CustomVQADataset:
    """Local SinglePageDocVQA dataset.

    Expects ``root_dir/{split}_v1.0.json`` + ``root_dir/images/...``;
    grayscale conversion happens in the image transform, not here. PIL is
    imported only when an item is read.
    """

    def __init__(self, root_dir: str, split: str):
        assert split in ("train", "val", "test"), f"bad split {split}"
        self.split = split
        self.root_dir = root_dir
        # layouts: root/{split}/processed_{split}_v1.0.json (train),
        # root/{split}/{split}_v1.0.json, or flat root/{split}_v1.0.json
        candidates = [
            os.path.join(root_dir, split, f"processed_{split}_v1.0.json"),
            os.path.join(root_dir, split, f"{split}_v1.0.json"),
            os.path.join(root_dir, f"{split}_v1.0.json"),
        ]
        anno_path = next((p for p in candidates if os.path.exists(p)), None)
        if anno_path is None:
            raise FileNotFoundError(f"none of {candidates} exist")
        # images are relative to the directory holding the annotation file
        self.img_dir = os.path.dirname(anno_path)
        with open(anno_path) as fh:
            loaded = json.load(fh)
        if isinstance(loaded, dict) and "data" in loaded:
            raw = loaded["data"]
        elif split == "train" and isinstance(loaded, dict):
            # reference processed-train format: {image_id: [qa strings]}
            self.entries = [
                {"image": img, "labels": qas, "question_id": -1}
                for img, qas in loaded.items()
            ]
            return
        else:
            raw = loaded

        # item shapes mirror the reference's: train labels are tag-formatted
        # Q&A strings (ready for the finetune collate), val labels a
        # {question, answers} dict (eval collate), test a question prompt
        if split == "train":
            by_image = {}
            for entry in raw:
                img = entry["image"]
                qa = (
                    "<s_question>" + entry["question"] + "</s_question>"
                    + "<s_answer>"
                    + (entry.get("answers") or [""])[0]
                    + "</s_answer>"
                )
                by_image.setdefault(img, []).append(qa)
            self.entries = [
                {"image": img, "labels": qas, "question_id": -1}
                for img, qas in by_image.items()
            ]
        elif split == "val":
            self.entries = [
                {
                    "image": entry["image"],
                    "labels": {
                        "question": entry["question"],
                        "answers": entry.get("answers", []),
                    },
                    "question_id": entry.get("questionId", entry.get("question_id")),
                }
                for entry in raw
            ]
        else:  # test: questions only
            self.entries = [
                {
                    "image": entry["image"],
                    "labels": "<s_question>" + entry["question"] + "</s_question>",
                    "question_id": entry.get("questionId", entry.get("question_id")),
                }
                for entry in raw
            ]

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx):
        from PIL import Image

        entry = dict(self.entries[idx])
        img_path = os.path.join(self.img_dir, entry["image"])
        entry["image"] = Image.open(img_path)
        return entry


class SafeDataset:
    """Wraps a dataset so a corrupt sample yields None instead of killing the
    run."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        try:
            return self.dataset[idx]
        except Exception as e:  # noqa: BLE001
            _logger.debug("corrupt sample %d: %s", idx, e)
            return None


def get_additional_tokens_from_dataset(
    all_special_tokens: List[str],
    dataset=None,
    dataset_id: str = "naver-clova-ix/cord-v2",
    split: str = "train",
) -> Optional[List[str]]:
    """Scan a CORD-style dataset once, running every ground-truth parse through
    ``json2token`` to accumulate the field special tokens. ``datasets`` is
    imported only when no dataset is given."""
    if dataset_id != "naver-clova-ix/cord-v2":
        return None
    if dataset is None:
        from datasets import load_dataset

        dataset = load_dataset(dataset_id)[split]

    discovered: List[str] = []
    for sample in dataset:
        gt = literal_eval(sample["ground_truth"]) if isinstance(
            sample["ground_truth"], str
        ) else sample["ground_truth"]
        parses = gt["gt_parses"] if "gt_parses" in gt else [gt["gt_parse"]]
        for parse in parses:
            _, discovered = json2token(
                parse, all_special_tokens, discovered, sort_json_key=True
            )
    return sorted(set(discovered))
