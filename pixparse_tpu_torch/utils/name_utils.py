"""Naming helpers (the port's copy of :mod:`pixparse_tpu.utils.name_utils`)."""

import re


def clean_name(name: str) -> str:
    """Make a model/dataset name filesystem- and flag-safe."""
    return name.replace("/", "_").replace("-", "_")


def natural_key(string_: str):
    """Sort key splitting digit runs so 'cfg10' sorts after 'cfg2'."""
    return [int(s) if s.isdigit() else s for s in re.split(r"(\d+)", string_.lower())]
