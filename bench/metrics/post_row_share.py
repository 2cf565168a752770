"""post_row_share: share of the window's planned rows whose strategy is
``post`` (the IVF path), from each result's ``plan.strategy``."""


def read(ctx):
    return ctx.strategies.count("post") / len(ctx.strategies) if ctx.strategies else None
