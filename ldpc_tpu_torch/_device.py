"""Device selection shared by the port's entry points.

Entry points take ``device`` (default ``"cuda"``).  Asking for the card on a
machine without one raises: the port never carries on quietly on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: expected 'cuda' or 'cpu'")
    return dev
