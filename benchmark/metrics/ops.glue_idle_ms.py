"""ops.glue_idle_ms (operators and expressions): device idle ms a query
charged to the program's operator runs and kernel wrappers (``op.*.run``,
``kernel.*`` spans innermost on the host): host glue between launches
inside the plan."""
from benchlib import program


def read(trace):
    v = program.view(trace)
    if v is None or not trace.queries or not trace.device:
        return None
    return sum(idle for s, idle in zip(v.spans, v.own_idle_ns)
               if program.is_glue(s[0])) / 1e6 / trace.queries
