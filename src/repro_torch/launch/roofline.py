"""Roofline terms of a step, from the analytic cost model.

Port of ``repro/launch/roofline.py``:

    compute    = FLOPs            / (chips x peak_FLOPs)
    memory     = HBM bytes        / (chips x HBM_bw)
    collective = collective bytes / (link_bw x links)   (bytes per device)

``HW`` holds the datasheet figures of an NVIDIA H100 SXM 80GB at 700 W,
not measurements: 989.4 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s
of HBM3, and NVLink 4 with 18 links of 25 GB/s a direction.  The
collective term models one NVLink domain (up to 8 GPUs, every GPU's 18
links to the switches); the network beyond it (InfiniBand between hosts)
is not modelled, as the reference models the TPU's ICI only.

PyTorch has no HLO, so the reference's parser of collective ops in the
optimized HLO text (``collective_bytes``) has no input here.  The terms
come from the analytic model (``launch/analytics.py``), which is the
reference's primary source too; without one they come from a traced
per-device cost (``{"flops", "bytes accessed"}``) and carry no collective
bytes.  ``coll_detail`` records the analytic payload and the traced
per-device figures.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["RooflineTerms", "analyse", "HW", "NVLINK_LINKS"]

HW = {
    "peak_flops": 989.4e12,   # bf16 dense, tensor cores (datasheet)
    "hbm_bw": 3.35e12,        # bytes/s of HBM3 (datasheet)
    "link_bw": 25e9,          # bytes/s a direction per NVLink 4 link (datasheet)
}
NVLINK_LINKS = 18             # NVLink 4 links per H100 SXM


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # total flops (all devices)
    hbm_bytes: float             # total HBM bytes (all devices)
    coll_bytes: float            # collective payload bytes per device
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0     # 6*N*D useful flops
    useful_ratio: float = 0.0    # model_flops / flops
    coll_detail: Optional[Dict[str, float]] = None

    def to_dict(self):
        return dataclasses.asdict(self)


def analyse(
    cost: Dict[str, float],
    chips: int,
    model_flops: float = 0.0,
    links: int = NVLINK_LINKS,
    analytic=None,
) -> RooflineTerms:
    """Derive the three roofline terms.  ``analytic`` (the analytic cost
    model's GLOBAL flops and hbm bytes and per-device collective bytes) is
    the primary source; ``cost`` holds the traced per-device ``flops`` and
    ``bytes accessed``, recorded beside it and used only without it."""
    traced_flops = float(cost.get("flops", 0.0))
    traced_bytes = float(cost.get("bytes accessed", 0.0))
    if analytic is not None:
        flops = analytic.flops
        hbm = analytic.hbm_bytes
        cbytes = analytic.coll_bytes_per_dev
    else:
        flops = traced_flops * chips
        hbm = traced_bytes * chips
        cbytes = 0.0

    compute_s = flops / (chips * HW["peak_flops"])
    memory_s = hbm / (chips * HW["hbm_bw"])
    # each device drives `links` links; payload crosses once per hop
    collective_s = cbytes / (HW["link_bw"] * links)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops / flops if flops else 0.0
    detail = {"analytic_coll_bytes_per_dev": float(cbytes),
              "traced_flops_per_dev": traced_flops, "traced_bytes_per_dev": traced_bytes}
    return RooflineTerms(
        flops=flops,
        hbm_bytes=hbm,
        coll_bytes=cbytes,
        chips=chips,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=useful,
        coll_detail=detail,
    )
