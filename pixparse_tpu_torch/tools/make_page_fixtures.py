"""Synthetic document pages for the native decoder's tests and the
``loader`` phase of ``chip_smoke.py``.

    python -m pixparse_tpu_torch.tools.make_page_fixtures [--out DIR]

writes ``page_<i>.jpg`` (grayscale, 2200x1700, JPEG quality 90) for i in
0..3 into ``pixparse_tpu_torch/tools/page_fixtures/``. The card machine can
decode a JPEG but has no encoder, so the pages are made here, with PIL, and
kept in the repository (under 2 MB together). :func:`synthetic_page` itself
needs numpy only: ``chip_smoke.py`` draws its PNG pages with it.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parent / "page_fixtures"
PAGE_SIZE = (2200, 1700)  # (height, width): a letter page scanned at 200 dpi
N_PAGES = 4
JPEG_QUALITY = 90


def synthetic_page(seed: int, height: int = PAGE_SIZE[0], width: int = PAGE_SIZE[1]) -> np.ndarray:
    """A uint8 (height, width) page: light paper, lines of dark word bars of
    seeded widths, heights and inks, paragraph gaps and ragged line ends."""
    rng = np.random.RandomState(seed)
    page = np.full((height, width), 248, np.uint8)
    margin = width // 12
    y = margin
    while y < height - margin:
        line_h = int(rng.randint(16, 28))
        x = margin
        end = width - margin - int(rng.randint(0, width // 4))
        ink = int(rng.randint(10, 80))
        while x < end:
            word = int(rng.randint(16, 150))
            page[y:y + line_h, x:min(x + word, end)] = ink
            x += word + int(rng.randint(8, 22))
        y += line_h + int(rng.randint(10, 18))
        if rng.rand() < 0.15:  # paragraph break
            y += int(rng.randint(30, 60))
    return page


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(FIXTURE_DIR))
    args = ap.parse_args(argv)
    from PIL import Image

    os.makedirs(args.out, exist_ok=True)
    total = 0
    for i in range(N_PAGES):
        path = os.path.join(args.out, f"page_{i}.jpg")
        Image.fromarray(synthetic_page(i), "L").save(path, format="JPEG", quality=JPEG_QUALITY)
        total += os.path.getsize(path)
        print(path, os.path.getsize(path))
    print("total bytes", total)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
