"""Serving helpers of the port: the compile-bucket ladder
(``serving/buckets.py``, a copy of the reference's)."""
from repro_torch.serving.buckets import (DEFAULT_CAPTURE, BucketLadder,
                                         CompileCache)

__all__ = ["DEFAULT_CAPTURE", "BucketLadder", "CompileCache"]
