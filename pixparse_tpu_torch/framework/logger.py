"""Logging setup (the port's copy of :mod:`pixparse_tpu.framework.logger`)."""

from __future__ import annotations

import logging


def setup_logging(log_file: str | None = None, debug: bool = False):
    level = logging.DEBUG if debug else logging.INFO
    fmt = "%(asctime)s | %(levelname)s | %(message)s"
    formatter = logging.Formatter(fmt, datefmt="%Y-%m-%d,%H:%M:%S")

    root = logging.getLogger()
    root.setLevel(level)
    stream = logging.StreamHandler()
    stream.setFormatter(formatter)
    root.addHandler(stream)
    if log_file:
        fh = logging.FileHandler(filename=log_file)
        fh.setFormatter(formatter)
        root.addHandler(fh)
