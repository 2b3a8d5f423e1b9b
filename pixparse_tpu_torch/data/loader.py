"""Loader factory (counterpart of :mod:`pixparse_tpu.data.loader`).

``create_loader`` builds the webdataset tar pipeline
(:mod:`pixparse_tpu_torch.data.wds`) and returns a :class:`LoaderBundle`
(``loader`` / ``num_batches`` / ``num_samples`` / ``set_interval``). The
``hf_dataset`` format of the JAX package is not ported yet and raises.
"""

from __future__ import annotations

from typing import Callable, Optional

from pixparse_tpu_torch.data.config import DatasetCfg
from pixparse_tpu_torch.data.wds import LoaderBundle, create_doc_anno_pipe, create_wds_loader


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
        raise NotImplementedError(
            "dataset format 'hf_dataset': the HF-datasets loader is not ported yet "
            "(ROADMAP.md Queue 1); use a webdataset source"
        )
    raise ValueError(f"unknown dataset format {cfg.format!r}")
