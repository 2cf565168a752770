"""The yardstick's kernel arithmetic and the card's peaks.

The work of one exact group of the masked top-k, frozen from the kernel
check of ``chip_smoke.py``: ``b`` queries against the ``n_pass`` passing
rows of the ``n`` rows the kernel is handed, at width ``d``, keeping ``k``.
Each input byte is read once and each output byte written once: the
queries, one mask byte a row handed over, each passing row, the (dist, id)
lists.  Operations: a ``2 d`` dot per (query, passing row) and the row's
norm.  The program hands the kernel the whole corpus under the mask when
more than ``FULL_SCAN_FRAC`` of it passes, else the passing rows gathered,
whose mask it does not read.

``peaks.json`` holds the published peaks a roofline share is stated
against, by ``torch.cuda.get_device_name()``: bytes per second of device
memory and the TF32 tensor-core rate, the least any fp32-accurate product
(three TF32 products, or fp32 on the CUDA cores) has to beat.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

__all__ = ["FULL_SCAN_FRAC", "masked_l2_topk_work", "least_seconds", "peaks"]

FULL_SCAN_FRAC = 0.25


def masked_l2_topk_work(b: int, n: int, n_pass: int, d: int, k: int) -> Tuple[int, int]:
    """(bytes, operations) of one exact group."""
    n_handed = n if n_pass > FULL_SCAN_FRAC * n else n_pass
    return 4 * b * d + n_handed + 4 * n_pass * d + 8 * b * k, 2 * b * n_pass * d + 2 * n_pass * d


def peaks(kind: str) -> Optional[dict]:
    """{"bytes_per_s", "flops"} for the card named ``kind``, or None."""
    table = json.loads((Path(__file__).with_name("peaks.json")).read_text())
    return table.get(kind)


def least_seconds(nbytes: float, ops: float, peak: dict) -> float:
    return max(nbytes / peak["bytes_per_s"], ops / peak["flops"])
