"""l2topk_launches_per_query: masked_l2_topk kernel launches in the window
(``kernels.ops.kernel_launches()``) over the window's queries."""


def read(ctx):
    n = ctx.launches.get("masked_l2_topk")
    return n / ctx.queries if n is not None and ctx.queries else None
