"""Loader factory (counterpart of :mod:`pixparse_tpu.data.loader`).

One ``create_loader`` over two formats, both returning a
:class:`LoaderBundle` (``loader`` / ``num_batches`` / ``num_samples`` /
``set_interval``):

- ``webdataset``: the tar pipeline (:mod:`pixparse_tpu_torch.data.wds`),
  shards split per process;
- ``hf_dataset``: an indexable dataset (``SinglePageDocVQA`` from the local
  directory ``$PIXPARSE_DOCVQA_DIR``, else ``datasets.load_dataset(source)
  [split]``, imported only there) wrapped in :class:`SafeDataset`, batched
  by :class:`HfDatasetLoader` with the task's collate.
"""

from __future__ import annotations

import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from pixparse_tpu_torch.data.config import DatasetCfg
from pixparse_tpu_torch.data.datasets_utils import CustomVQADataset, SafeDataset
from pixparse_tpu_torch.data.wds import (
    LoaderBundle,
    create_doc_anno_pipe,
    create_wds_loader,
    default_collate,
)


_END = object()  # the producer's end of stream; a collate may return None


class HfDatasetLoader:
    """Batched iterator over an indexable dataset with per-process striping
    (the JAX package's index order for the same seed, interval, world size
    and rank).

    Train: per-interval shuffle (``random.Random(seed + interval)``) of all
    indices, this process's stripe, full batches only; a corrupt (None)
    sample is replaced by a random draw (``random.Random(seed * 7919 +
    interval)``), at most 50 draws. Eval: dataset order, final partial batch
    kept, corrupt samples dropped. Items are fetched in a thread pool and
    collated in a producer thread ahead of the consumer.

    Unlike the JAX loader, a batch the collate returns as ``None`` (an eval
    batch of unreadable pages) reaches the consumer as ``None`` instead of
    ending the epoch: the end of the stream is a private sentinel.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        is_train: bool,
        seed: int = 0,
        world_size: int = 1,
        global_rank: int = 0,
        num_workers: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.is_train = is_train
        self.seed = seed
        self.world_size = max(1, world_size)
        self.global_rank = global_rank
        self.num_workers = max(1, num_workers)
        self.interval = 0

    def set_interval(self, interval: int):
        self.interval = interval

    set_epoch = set_interval

    def _indices(self):
        order = list(range(len(self.dataset)))
        if self.is_train:
            random.Random(self.seed + self.interval).shuffle(order)
        return order[self.global_rank::self.world_size]

    def batch_indices(self):
        """This interval's batches of dataset indices, before any backfill."""
        indices = self._indices()
        batches = [indices[i:i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
        if self.is_train:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def __len__(self):
        per_proc = len(self._indices())
        if self.is_train:
            return per_proc // self.batch_size
        return -(-per_proc // self.batch_size)

    def __iter__(self):
        batches = self.batch_indices()
        q: "queue.Queue" = queue.Queue(maxsize=self.num_workers * 2)
        stop = threading.Event()
        n = len(self.dataset)
        backfill_rng = random.Random(self.seed * 7919 + self.interval)

        def fetch_one(i):
            item = self.dataset[i]
            retries = 0
            while item is None and self.is_train and retries < 50:
                item = self.dataset[backfill_rng.randrange(n)]
                retries += 1
            if item is None and self.is_train:
                # a short train batch would change the step's shapes
                raise RuntimeError(
                    "could not backfill a corrupt sample after 50 draws: "
                    "the dataset appears mostly unreadable"
                )
            return item

        pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def producer():
            try:
                for batch_idx in batches:
                    if stop.is_set():
                        return
                    items = [x for x in pool.map(fetch_one, batch_idx) if x is not None]
                    if items:
                        q.put(self.collate_fn(items))
            except Exception as e:  # raised in the consumer, never a silent end
                q.put(e)
            finally:
                q.put(_END)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def create_loader(
    cfg: DatasetCfg,
    is_train: bool,
    image_preprocess: Optional[Callable] = None,
    anno_preprocess: Optional[Callable] = None,
    collate_fn: Optional[Callable] = None,
    image_key: str = "pdf;tif;tiff;png;jpg;jpeg",
    image_fmt: str = "L",
    start_interval: int = 0,
    seed: int = 0,
    world_size: int = 1,
    global_rank: int = 0,
    create_decoder_pipe: Callable = create_doc_anno_pipe,
) -> LoaderBundle:
    if cfg.format == "webdataset":
        decoder = create_decoder_pipe(
            image_preprocess=image_preprocess,
            anno_preprocess=anno_preprocess,
            image_key=image_key,
            image_fmt=image_fmt,
        )
        bundle = create_wds_loader(
            cfg.source,
            decoder,
            is_train=is_train,
            num_samples=cfg.num_samples,
            workers=cfg.num_workers,
            batch_size=cfg.batch_size,
            seed=seed,
            world_size=world_size,
            global_rank=global_rank,
        )
        bundle.set_interval(start_interval)
        return bundle
    if cfg.format == "hf_dataset":
        if cfg.source == "SinglePageDocVQA":
            root = os.environ.get(
                "PIXPARSE_DOCVQA_DIR", os.path.expanduser("~/.cache/SinglePageDocVQA")
            )
            dataset = CustomVQADataset(root_dir=root, split=cfg.split)
        else:
            from datasets import VerificationMode, load_dataset

            dataset = load_dataset(cfg.source, verification_mode=VerificationMode.ALL_CHECKS)[
                cfg.split
            ]
        dataset = SafeDataset(dataset)
        loader = HfDatasetLoader(
            dataset,
            batch_size=cfg.batch_size,
            collate_fn=collate_fn,
            is_train=is_train,
            seed=seed,
            world_size=world_size,
            global_rank=global_rank,
            num_workers=cfg.num_workers,
        )
        loader.set_interval(start_interval)
        return LoaderBundle(loader=loader, num_batches=len(loader), num_samples=len(dataset))
    raise ValueError(f"unknown dataset format {cfg.format!r}")
