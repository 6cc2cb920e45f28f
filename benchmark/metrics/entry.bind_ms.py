"""entry.bind_ms (entry): host ms a query in the program's own outermost
``query.bind`` spans (``compile_plan``), the inside twin of host.bind_ms."""
from benchlib import program


def read(trace):
    v = program.view(trace)
    if v is None or not trace.queries:
        return None
    return sum(v.spans[i][2] - v.spans[i][1]
               for i in v.top("query.bind")) / 1e6 / trace.queries
