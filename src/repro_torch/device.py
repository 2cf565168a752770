"""Device selection and the fp32 product setting shared by the port.

Every entry point takes an explicit ``device``; the default is ``"cuda"``.
Asking for a card that is not there raises: nothing carries on silently on
the CPU.  The CPU is used only when the caller names it (the tests do).
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "strict_fp32"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def strict_fp32() -> None:
    """Full-precision fp32 products: TF32 keeps ~3 decimal digits, which
    breaks the 2e-4 distance band the port is held to."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
