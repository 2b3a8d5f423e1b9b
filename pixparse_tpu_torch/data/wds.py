"""Webdataset-compatible tar-shard reader and loader (the port's own copy of
:mod:`pixparse_tpu.data.wds`; numpy and the standard library only).

- ``expand_shards``: brace expansion (``shard-{0000..0699}.tar``), ``::``
  multi-source separation, ``pipe:cmd`` subprocess sources.
- shards are split across processes by ``global_rank``/``world_size`` and
  across worker threads within a process.
- ``set_interval(i)`` reseeds the shard shuffle and the sample shuffle buffer
  with ``seed + interval``, so runs are resumable mid-training.
- train loaders are infinite (shards re-shuffled and re-looped) and sliced to
  ``num_batches = num_samples // global_batch`` per interval; eval loaders
  make a single deterministic pass.
- decode and preprocess run in a small thread pool feeding a bounded queue,
  which overlaps host-side preprocessing with device steps.

JPEG and PNG pages are decoded by the native library
(:mod:`pixparse_tpu_torch.native`); other formats by PIL, imported inside
the function that decodes.
"""

from __future__ import annotations

import io
import json
import logging
import queue
import random
import re
import subprocess
import tarfile
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List

import numpy as np

from pixparse_tpu_torch.native import choose_jpeg_scale, decode_image

_logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# shard expansion
# --------------------------------------------------------------------------

_RANGE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")
_ALT_RE = re.compile(r"\{([^{}]*,[^{}]*)\}")


def braceexpand(pattern: str) -> List[str]:
    """Minimal brace expansion: numeric ranges ``{0000..0699}`` (width kept)
    and alternation ``{a,b,c}``. Applied recursively, leftmost-first."""
    m = _RANGE_RE.search(pattern)
    if m:
        lo, hi = m.group(1), m.group(2)
        width = len(lo)
        out = []
        for v in range(int(lo), int(hi) + 1):
            out.extend(braceexpand(pattern[: m.start()] + str(v).zfill(width) + pattern[m.end():]))
        return out
    m = _ALT_RE.search(pattern)
    if m:
        out = []
        for alt in m.group(1).split(","):
            out.extend(braceexpand(pattern[: m.start()] + alt + pattern[m.end():]))
        return out
    return [pattern]


def expand_shards(source) -> List[str]:
    """Source spec -> explicit shard list. Accepts a list, a ``::``-separated
    string of specs, and brace patterns. ``pipe:`` prefixes survive expansion."""
    if isinstance(source, (list, tuple)):
        specs = list(source)
    else:
        specs = [s for s in str(source).split("::") if s]
    shards: List[str] = []
    for spec in specs:
        shards.extend(braceexpand(spec.strip()))
    if not shards:
        raise ValueError(f"no shards from source spec {source!r}")
    return shards


# --------------------------------------------------------------------------
# tar streaming
# --------------------------------------------------------------------------

class _ReadaheadStream(io.RawIOBase):
    """Drain a subprocess pipe from a background thread into a bounded
    chunk queue so the producer streams continuously while the consumer
    holds the GIL decoding/transforming.

    Without this, tarfile's ~10 KB reads against the 64 KB OS pipe stall
    the producer for the whole transform phase of every sample (measured
    24% pipeline-throughput loss on ``pipe:cat`` sources vs direct files).
    The blocking reads here release the GIL, so the thread costs nothing.
    """

    def __init__(self, raw, chunk: int = 1 << 18, depth: int = 32):
        self._raw = raw
        self._chunk = chunk
        self._q: "queue.Queue[bytes]" = queue.Queue(maxsize=depth)
        self._buf = memoryview(b"")
        self._eof = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            while True:
                b = self._raw.read(self._chunk)
                self._q.put(b)
                if not b:
                    return
        except Exception:
            self._q.put(b"")  # surface as EOF; tarfile raises on short data

    def readable(self) -> bool:
        return True

    def read(self, n: int = -1) -> bytes:
        out = []
        need = n if n is not None and n >= 0 else float("inf")
        while need > 0:
            if not self._buf:
                if self._eof:
                    break
                nxt = self._q.get()
                if not nxt:
                    self._eof = True
                    break
                self._buf = memoryview(nxt)
            take = min(len(self._buf), need) if need != float("inf") else len(self._buf)
            out.append(bytes(self._buf[:take]))
            self._buf = self._buf[take:]
            need -= take
        return b"".join(out)

    def close(self):
        if not self.closed:
            try:
                self._raw.close()  # fill thread errors out on its next read
            except Exception:
                pass
            # unblock a producer stuck on a full queue so its thread exits
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        super().close()


def _open_shard(url: str):
    if url.startswith("pipe:"):
        cmd = url[len("pipe:"):].strip()
        proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE)
        return _ReadaheadStream(proc.stdout), proc
    return open(url, "rb"), None


def iter_tar_samples(url: str) -> Iterator[Dict[str, Any]]:
    """Stream one tar shard, grouping members into webdataset samples:
    files ``key.ext`` with the same key become ``{'__key__': key, ext: bytes}``."""
    stream, proc = _open_shard(url)
    try:
        with tarfile.open(fileobj=stream, mode="r|*") as tf:
            current_key = None
            sample: Dict[str, Any] = {}
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name
                if "/" in name:
                    name = name.rsplit("/", 1)[1]
                if "." not in name:
                    key, ext = name, ""
                else:
                    key, ext = name.split(".", 1)
                if key != current_key:
                    if sample:
                        yield sample
                    current_key = key
                    sample = {"__key__": key, "__url__": url}
                data = tf.extractfile(member)
                if data is not None:
                    sample[ext.lower()] = data.read()
            if sample:
                yield sample
    finally:
        try:
            stream.close()
        except Exception:
            pass
        if proc is not None:
            proc.wait()


# --------------------------------------------------------------------------
# document decode pipeline
# --------------------------------------------------------------------------

DEFAULT_IMAGE_KEY = "pdf;tif;tiff;png;jpg;jpeg"


def decode_image_bytes(
    data: bytes, ext: str, image_fmt: str = "L", page_index: int = 0, target_size=None
):
    """Bytes -> (H, W, C) uint8 array or PIL image in ``image_fmt``.

    JPEG and PNG in ``L`` / ``RGB`` take the native decoder
    (:mod:`pixparse_tpu_torch.native`) when its library builds; with
    ``target_size`` (h, w) a JPEG decodes DCT-scaled (1/2..1/8, never below
    the target). PIL is imported only on the paths that still need it: TIFF
    (multi-page TIFF seeks ``page_index``) and other formats, other modes,
    or no native library (then a JPEG's DCT scale goes through PIL's
    ``draft``). PDF rendering needs pypdfium2."""
    if ext in ("jpg", "jpeg", "png") and image_fmt in ("L", "RGB"):
        arr = decode_image(data, gray=image_fmt == "L", target_size=target_size)
        if arr is not None:
            return arr
    from PIL import Image

    if ext == "pdf":
        try:
            import pypdfium2 as pdfium  # optional
        except ImportError as e:
            raise RuntimeError(
                "PDF shard decoding requires pypdfium2 (not installed); "
                "render shards to tiff/png first"
            ) from e
        pdf = pdfium.PdfDocument(data)
        page = pdf[min(page_index, len(pdf) - 1)]
        pil = page.render(scale=2.0).to_pil()
        return pil.convert(image_fmt)
    img = Image.open(io.BytesIO(data))
    if target_size is not None and img.format == "JPEG":
        w, h = img.size
        d = choose_jpeg_scale(h, w, *target_size)
        if d > 1:
            img.draft(image_fmt, (w // d, h // d))
    n_frames = getattr(img, "n_frames", 1)
    if n_frames > 1:
        img.seek(min(page_index, n_frames - 1))
    return img.convert(image_fmt)


def create_doc_anno_pipe(
    image_preprocess: Callable,
    anno_preprocess: Callable,
    image_key: str = DEFAULT_IMAGE_KEY,
    image_fmt: str = "L",
):
    """Decoder for (document image, json annotation) samples.

    Returns fn(sample) -> (image, text, target) tuple or None (skip), the
    tuple layout the train tasks consume.
    The annotation is preprocessed first so its sampled page index selects the
    image page (multi-page formats)."""
    image_exts = [e.strip() for e in image_key.split(";") if e.strip()]
    target_size = _decode_target_size(image_preprocess)

    def decode(sample: Dict[str, Any]):
        ext = next((e for e in image_exts if e in sample), None)
        if ext is None or "json" not in sample:
            return None
        try:
            anno = json.loads(sample["json"])
            out = anno_preprocess(anno)
            if isinstance(out, tuple):
                token_dict, info = out
                page_index = int(info["page_indices"][0])
            else:
                token_dict, page_index = out, 0
            img = decode_image_bytes(
                sample[ext], ext, image_fmt, page_index, target_size=target_size
            )
            image = image_preprocess(img)
            if isinstance(image, dict):  # variable-resolution patch dicts
                image = {k: np.asarray(v) for k, v in image.items()}
            else:
                image = np.asarray(image)
            return (
                image,
                np.asarray(token_dict["text"][0]),
                np.asarray(token_dict["target"][0]),
            )
        except Exception as e:
            _logger.debug("skipping sample %s: %s", sample.get("__key__"), e)
            return None

    return decode


def create_image_text_pipe(
    image_preprocess: Callable,
    anno_preprocess: Callable,
    image_key: str = DEFAULT_IMAGE_KEY,
    image_fmt: str = "L",
):
    """Eval decoder (what ``app.eval`` reads with): the train pipe's
    ``(image, text, target)`` tuples; the eval task's annotation
    preprocessing decides what ``text`` holds."""
    return create_doc_anno_pipe(
        image_preprocess, anno_preprocess, image_key=image_key, image_fmt=image_fmt
    )


def _decode_target_size(image_preprocess):
    """Decode-time DCT-scale target: the transform's canvas size."""
    size = getattr(image_preprocess, "image_size", None)
    return tuple(size) if size else None


def default_collate(samples: List):
    """Stack a list of (possibly nested tuple/dict) numpy samples into batch
    arrays, preserving structure."""
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(
            default_collate([s[i] for s in samples]) for i in range(len(first))
        )
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    return np.stack(samples)


# --------------------------------------------------------------------------
# loader
# --------------------------------------------------------------------------

_QUEUE_SENTINEL = object()


@dataclass
class WdsLoader:
    """Iterable over collated batches from tar shards (one interval per
    iteration for train; one full pass for eval)."""

    shards: List[str]
    decoder: Callable
    batch_size: int
    is_train: bool
    num_batches: int  # per-process batches per interval (train) or pass (eval)
    seed: int = 0
    world_size: int = 1
    global_rank: int = 0
    num_workers: int = 4
    shuffle_buffer: int = 256
    collate_fn: Callable = default_collate
    interval: int = 0

    def set_interval(self, interval: int):
        self.interval = interval

    def set_epoch(self, epoch: int):
        self.interval = epoch

    def _my_shards(self, rng: random.Random) -> List[str]:
        shards = list(self.shards)
        if self.is_train:
            rng.shuffle(shards)
        mine = shards[self.global_rank % max(1, len(shards))::self.world_size]
        return mine or shards[:1]

    def _sample_stream(self) -> Iterator[Any]:
        """Decoded sample stream for this process/interval (threaded)."""
        rng = random.Random(self.seed + self.interval)
        my_shards = self._my_shards(rng)
        if self.is_train:
            # infinite: cycle re-shuffled shard list
            def shard_iter():
                i = 0
                while True:
                    order = list(my_shards)
                    random.Random(self.seed + self.interval + i).shuffle(order)
                    yield from order
                    i += 1
            shards_it = shard_iter()
        else:
            shards_it = iter(my_shards)

        # eval passes must be deterministic: multi-worker interleave is
        # scheduling-dependent, so eval streams use one worker
        n_workers = max(1, self.num_workers) if self.is_train else 1
        out_q: "queue.Queue" = queue.Queue(maxsize=n_workers * 64)
        shard_lock = threading.Lock()
        stop = threading.Event()

        def next_shard():
            with shard_lock:
                return next(shards_it, None)

        # a train stream cycles shards forever; if every shard in a row fails
        # (missing files, bad tars) we must bail instead of spinning silently
        max_consecutive_failures = max(4, 2 * len(my_shards))

        def worker():
            failures = 0
            try:
                while not stop.is_set():
                    url = next_shard()
                    if url is None:
                        break
                    produced = False
                    try:
                        for raw in iter_tar_samples(url):
                            if stop.is_set():
                                return
                            decoded = self.decoder(raw)
                            if decoded is not None:
                                out_q.put(decoded)
                                produced = True
                    except Exception as e:
                        _logger.warning("shard %s failed: %s", url, e)
                    if produced:
                        failures = 0
                    else:
                        failures += 1
                        if failures >= max_consecutive_failures:
                            _logger.error(
                                "%d consecutive shards yielded no samples; "
                                "stopping worker (source misconfigured?)",
                                failures,
                            )
                            break
            finally:
                out_q.put(_QUEUE_SENTINEL)

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(n_workers)]
        for t in threads:
            t.start()

        finished_workers = 0
        try:
            while finished_workers < n_workers:
                item = out_q.get()
                if item is _QUEUE_SENTINEL:
                    finished_workers += 1
                    continue
                yield item
        finally:
            stop.set()
            # drain so workers blocked on put() can exit
            while any(t.is_alive() for t in threads):
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break

    def __iter__(self):
        rng = random.Random((self.seed + 1) * 31 + self.interval)
        stream = self._sample_stream()
        if self.is_train and self.shuffle_buffer > 1:
            stream = _shuffled(stream, self.shuffle_buffer, rng)

        batch: List[Any] = []
        emitted = 0
        for sample in stream:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
                emitted += 1
                if emitted >= self.num_batches:
                    return
        if batch and not self.is_train:
            yield self.collate_fn(batch)

    def __len__(self):
        return self.num_batches


def _shuffled(stream: Iterator, bufsize: int, rng: random.Random) -> Iterator:
    buf: List[Any] = []
    for item in stream:
        if len(buf) < bufsize:
            buf.append(item)
            continue
        idx = rng.randrange(bufsize)
        yield buf[idx]
        buf[idx] = item
    rng.shuffle(buf)
    yield from buf


@dataclass
class LoaderBundle:
    """Loader plus the bookkeeping the apps and tasks consume."""

    loader: Any
    num_batches: int
    num_samples: int
    sampler: Any = None

    def set_interval(self, interval: int):
        if hasattr(self.loader, "set_interval"):
            self.loader.set_interval(interval)
        elif self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(interval)


def create_wds_loader(
    source,
    decoder: Callable,
    is_train: bool,
    num_samples: int,
    workers: int = 4,
    batch_size: int = 8,
    seed: int = 0,
    world_size: int = 1,
    global_rank: int = 0,
    collate_fn: Callable = default_collate,
) -> LoaderBundle:
    shards = expand_shards(source)
    global_batch = batch_size * max(1, world_size)
    if is_train:
        num_batches = max(1, num_samples // global_batch)
    else:
        num_batches = max(1, -(-num_samples // global_batch))
    loader = WdsLoader(
        shards=shards,
        decoder=decoder,
        batch_size=batch_size,
        is_train=is_train,
        num_batches=num_batches,
        seed=seed,
        world_size=world_size,
        global_rank=global_rank,
        num_workers=workers,
        collate_fn=collate_fn,
    )
    return LoaderBundle(
        loader=loader,
        num_batches=num_batches,
        num_samples=num_samples,
    )
