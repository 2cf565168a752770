"""setup_s: process start to the first timed call (imports, the corpus on
the card, build(), fit() and the warm-up)."""


def read(ctx):
    return ctx.setup_s
