"""bitmap_compile_ms_per_query: wall of the program's ``bitmap_compile``
spans (each predicate-cache miss's bitmap: label and range words, the
bucket OR, boundary packing, popcount) over the window's queries."""


def read(ctx):
    walls = [s.wall_s for s in ctx.spans if s.name == "bitmap_compile"]
    return 1e3 * sum(walls) / ctx.queries if walls and ctx.queries else None
