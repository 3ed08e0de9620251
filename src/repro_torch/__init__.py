"""PyTorch/CUDA port of the ``repro`` serving path.

The JAX package ``repro`` stays the reference; this package imports
``torch`` and never ``jax`` or ``repro``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on a CPU tensor every kernel
wrapper takes its plain PyTorch version (``repro_torch.kernels.ref``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def default_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is given.
    Raises when no device is given and CUDA is missing; never falls back
    to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and found no CUDA device; "
            "pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda")
