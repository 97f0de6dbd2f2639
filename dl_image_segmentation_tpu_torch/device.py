"""Device resolution for the port's entry points.

Entry points take ``device=None``, which means the CUDA card. Without a
card they raise rather than run on the CPU: the CPU runs only when the
caller asks for it with ``device="cpu"``."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device`` (None -> "cuda"); raises when CUDA
    is asked for and ``torch.cuda.is_available()`` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
