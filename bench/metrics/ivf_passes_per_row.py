"""ivf_passes_per_row: rows searched by the program's ``ivf.search`` spans
(their ``n_rows``, summed) over the rows of the ``group`` spans with
decision ``post``: 1.0 when no row doubles α."""


def read(ctx):
    rows = sum(int(s.attrs.get("n_rows", 0)) for s in ctx.spans
               if s.name == "group" and s.attrs.get("decision") == "post")
    searched = [int(s.attrs["n_rows"]) for s in ctx.spans
                if s.name == "ivf.search" and "n_rows" in s.attrs]
    return sum(searched) / rows if searched and rows else None
