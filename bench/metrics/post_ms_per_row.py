"""post_ms_per_row: wall of the ``group`` spans with decision ``post`` over
the rows they carried (``n_rows``); nothing where no row was planned post."""


def read(ctx):
    groups = [s for s in ctx.spans if s.name == "group" and s.attrs.get("decision") == "post"]
    rows = sum(int(s.attrs.get("n_rows", 0)) for s in groups)
    return 1e3 * sum(s.wall_s for s in groups) / rows if rows else None
