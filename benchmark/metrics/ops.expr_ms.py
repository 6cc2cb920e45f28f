"""ops.expr_ms (operators and expressions): device ms a query that the
Filter, Compute and Project nodes hold the device stream, less the nodes
they run (CUDA events at each node's run).  A predicate that bind fuses
into a join or an aggregate counts there."""
from benchlib import program


def read(trace):
    v = program.view(trace)
    if v is None or not trace.queries or not v.has_node(program.EXPRESSIONS):
        return None
    return v.node_ms(program.EXPRESSIONS) / trace.queries
