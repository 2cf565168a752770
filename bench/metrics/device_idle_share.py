"""device_idle_share: 1 - (union of device activity) / traced window, from
the profiler's trace of the window."""


def read(ctx):
    p = ctx.profile
    return 1.0 - p.busy_s / p.window_s if p is not None and p.window_s > 0 else None
