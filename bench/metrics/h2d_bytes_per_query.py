"""h2d_bytes_per_query: the ``bytes`` of the program's ``h2d`` spans (host
arrays handed to the device on the serving path: an exact group's queries
and mask, an IVF search's queries and candidate indices) over the window's
queries."""


def read(ctx):
    sizes = [s.attrs["bytes"] for s in ctx.spans if s.name == "h2d" and "bytes" in s.attrs]
    return sum(sizes) / ctx.queries if sizes and ctx.queries else None
