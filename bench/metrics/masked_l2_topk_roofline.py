"""masked_l2_topk_roofline: the least time the card could take for the
window's exact groups, each from the yardstick's work count
(``bench/work.py``) at its ``n_rows`` queries and ``n_candidates`` passing
rows, summed, over the summed device time of the kernel's own launches
(the names below) in the profiler's trace; in percent."""
from bench.work import least_seconds, masked_l2_topk_work, peaks

KERNELS = ("l2_topk_stream", "l2_topk_tiled", "l2_topk_merge")
EXACT = ("pre", "ipre")


def read(ctx):
    peak = peaks(ctx.device_kind)
    if ctx.profile is None or peak is None:
        return None
    busy = ctx.profile.device_seconds(KERNELS)
    least = 0.0
    for s in ctx.spans:
        if s.name == "group" and s.attrs.get("decision") in EXACT and s.attrs.get("n_candidates"):
            nbytes, ops = masked_l2_topk_work(int(s.attrs["n_rows"]), ctx.rows,
                                              int(s.attrs["n_candidates"]), ctx.dim, ctx.k)
            least += least_seconds(nbytes, ops, peak)
    return 100.0 * least / busy if busy > 0 and least > 0 else None
