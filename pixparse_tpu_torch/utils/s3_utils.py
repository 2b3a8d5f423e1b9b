"""S3 checkpoint fetch (the port's copy of :mod:`pixparse_tpu.utils.s3_utils`).

``boto3`` is imported inside the function, so local-path flows never touch
it; without it the call raises ``ModuleNotFoundError``.
"""

from __future__ import annotations

import io

import torch


def load_checkpoint_from_s3(bucket_name: str, s3_file_key: str):
    """Download ``s3://bucket/key`` and ``torch.load`` it from memory on the
    CPU (``weights_only``, as the local ``.pt`` loader reads a file)."""
    import boto3

    s3 = boto3.client("s3")
    buffer = io.BytesIO()
    s3.download_fileobj(bucket_name, s3_file_key, buffer)
    buffer.seek(0)
    return torch.load(buffer, map_location="cpu", weights_only=True)
