"""ivf_ms_per_row: wall of the program's ``ivf.search`` spans (the post
path's IVF searches, every α-doubling round) over the rows of the ``group``
spans with decision ``post`` (``post_ms_per_row``'s denominator)."""


def read(ctx):
    rows = sum(int(s.attrs.get("n_rows", 0)) for s in ctx.spans
               if s.name == "group" and s.attrs.get("decision") == "post")
    walls = [s.wall_s for s in ctx.spans if s.name == "ivf.search"]
    return 1e3 * sum(walls) / rows if walls and rows else None
