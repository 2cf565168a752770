"""post_check_ms_per_row: wall of the program's ``post.check`` spans (the
host predicate checks on the IVF's candidates and the first-k pick, every
α-doubling round) over the rows of the ``group`` spans with decision
``post``."""


def read(ctx):
    rows = sum(int(s.attrs.get("n_rows", 0)) for s in ctx.spans
               if s.name == "group" and s.attrs.get("decision") == "post")
    walls = [s.wall_s for s in ctx.spans if s.name == "post.check"]
    return 1e3 * sum(walls) / rows if walls and rows else None
