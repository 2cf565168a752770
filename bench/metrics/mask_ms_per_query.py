"""mask_ms_per_query: wall of the program's ``mask`` spans (an exact or
routed group's candidate mask: the bitmap cache's expansion or the
columnar scan, and an exact group's passing count) over the window's
queries."""


def read(ctx):
    walls = [s.wall_s for s in ctx.spans if s.name == "mask"]
    return 1e3 * sum(walls) / ctx.queries if walls and ctx.queries else None
