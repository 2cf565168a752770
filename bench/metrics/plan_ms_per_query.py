"""plan_ms_per_query: wall of the program's root ``plan`` spans
(``make_plan_batch``) over the window's queries."""


def read(ctx):
    walls = [s.wall_s for s in ctx.spans if s.name == "plan" and s.parent_id == -1]
    return 1e3 * sum(walls) / ctx.queries if walls and ctx.queries else None
