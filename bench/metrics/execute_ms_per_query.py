"""execute_ms_per_query: wall of the program's root ``execute`` spans
(``_execute_grouped`` and the results' collapse) over the window's queries."""


def read(ctx):
    walls = [s.wall_s for s in ctx.spans if s.name == "execute" and s.parent_id == -1]
    return 1e3 * sum(walls) / ctx.queries if walls and ctx.queries else None
