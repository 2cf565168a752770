"""recall_at_10: mean recall@k of the compared queries against the
reference's exact answer, every plan included (k is the mix's, 10)."""


def read(ctx):
    return ctx.readings.recall
