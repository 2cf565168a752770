"""Render the roofline and dry-run tables from the dry-run's records.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir results/dryrun_torch] \\
        [--baseline DIR]

Port of ``repro/launch/report.py``: the same three tables.  The reference's
"fits 16G" column (TPU v5e HBM) is "fits 80G" here (H100 80GB HBM3), from
one device's argument bytes plus its traced ``temp_bytes``; the dry-run
table shows the traced flops and bytes a device and the analytic
collective payload a device (PyTorch has no HLO to parse).  A cell whose
step was not traced shows "—" where a traced figure would stand.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

FIT_BYTES = 80 * 2**30      # H100 80GB HBM3


def load(d: str) -> List[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def _gib(b) -> str:
    return "—" if b is None else f"{b / 2**30:.2f}"


def _fits(r: dict) -> str:
    mem = r["memory_analysis"]
    if mem.get("temp_bytes") is None:
        return "—"
    return "yes" if mem["argument_bytes"] + mem["temp_bytes"] < FIT_BYTES else "NO"


def roofline_table(rows: List[dict], mesh="16x16") -> str:
    out = [
        "| arch | shape | compute_s | memory_s | collective_s | bottleneck | "
        "MODEL_FLOPS | useful | temp GiB/dev | fits 80G |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("status") == "skipped" and r["mesh"] == mesh:
            out.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | *skipped* | — | — | — | — |"
            )
            continue
        if r.get("status") != "ok" or r["mesh"] != mesh:
            continue
        t = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.4f} | {t['memory_s']:.4f} "
            f"| {t['collective_s']:.4f} | **{t['bottleneck']}** | {t['model_flops']:.3g} "
            f"| {t['useful_ratio']:.2f} | {_gib(r['memory_analysis']['temp_bytes'])} | "
            f"{_fits(r)} |"
        )
    return "\n".join(out)


def dryrun_table(rows: List[dict]) -> str:
    out = [
        "| arch | shape | mesh | status | traced flops/dev | traced bytes/dev | "
        "collectives (analytic, per dev) | temp GiB/dev | trace s |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("status") == "skipped":
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | skip: "
                f"{r['reason'][:60]}… | | | | | |"
            )
            continue
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR | | | | | |")
            continue
        traced = r.get("cost_flops") is not None
        flops = f"{r['cost_flops']:.3g}" if traced else "—"
        nbytes = f"{r['cost_bytes']:.3g}" if traced else "—"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | {flops} | {nbytes} | "
            f"{r['roofline']['coll_bytes'] / 2**20:.0f} MiB | "
            f"{_gib(r['memory_analysis']['temp_bytes'])} | {r.get('compile_s', 0):.1f} |"
        )
    return "\n".join(out)


def before_after(base: List[dict], opt: List[dict]) -> str:
    bidx = {(r["arch"], r["shape"], r["mesh"]): r for r in base if r.get("status") == "ok"}
    out = [
        "| cell | metric | baseline | optimized | Δ |",
        "|---|---|---|---|---|",
    ]
    for r in opt:
        if r.get("status") != "ok" or r["mesh"] != "16x16":
            continue
        key = (r["arch"], r["shape"], r["mesh"])
        b = bidx.get(key)
        if not b or None in (b["memory_analysis"]["temp_bytes"],
                             r["memory_analysis"]["temp_bytes"]):
            continue
        mb = b["memory_analysis"]["temp_bytes"] / 2**30
        mo = r["memory_analysis"]["temp_bytes"] / 2**30
        dom_b = max(b["roofline"]["compute_s"], b["roofline"]["memory_s"],
                    b["roofline"]["collective_s"])
        dom_o = max(r["roofline"]["compute_s"], r["roofline"]["memory_s"],
                    r["roofline"]["collective_s"])
        if abs(mb - mo) / max(mb, 1e-9) > 0.05 or abs(dom_b - dom_o) / max(dom_b, 1e-9) > 0.05:
            out.append(
                f"| {r['arch']}·{r['shape']} | temp GiB / dominant-term s | "
                f"{mb:.1f} / {dom_b:.3f} | {mo:.1f} / {dom_o:.3f} | "
                f"{(1-mo/max(mb,1e-9))*100:+.0f}% mem, {(1-dom_o/max(dom_b,1e-9))*100:+.0f}% time |"
            )
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join("results", "dryrun_torch"))
    ap.add_argument("--baseline", default=os.path.join("results", "dryrun_torch_baseline"))
    ap.add_argument("--mode", default="all", choices=["roofline", "dryrun", "diff", "all"])
    args = ap.parse_args(argv)
    rows = load(args.dir)
    if args.mode in ("roofline", "all"):
        print("### Roofline (single pod, 16x16)\n")
        print(roofline_table(rows))
    if args.mode in ("dryrun", "all"):
        print("\n### Dry-run record (both meshes)\n")
        print(dryrun_table(rows))
    if args.mode in ("diff", "all") and os.path.isdir(args.baseline):
        print("\n### Before/after (baseline -> optimized)\n")
        print(before_after(load(args.baseline), rows))


if __name__ == "__main__":
    main()
