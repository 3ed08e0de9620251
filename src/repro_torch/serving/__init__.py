"""Serving of the port: the continuous batcher (``serving/scheduler.py``,
dense and paged, with the prefix cache, tenants, preemption, spec decode,
telemetry and one CUDA graph per decode shape) and the compile-bucket
ladder (``serving/buckets.py``, a copy of the reference's)."""
from repro_torch.serving.buckets import (DEFAULT_CAPTURE, BucketLadder,
                                         CompileCache)
from repro_torch.serving.scheduler import ContinuousBatcher, Request

__all__ = ["DEFAULT_CAPTURE", "BucketLadder", "CompileCache",
           "ContinuousBatcher", "Request"]
