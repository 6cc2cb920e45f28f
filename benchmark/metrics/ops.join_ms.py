"""ops.join_ms (operators and expressions): device ms a query that the join
nodes (HashJoin, RowidMergeJoin, ForeignFilter) hold the device stream,
less the nodes they run (CUDA events at each node's run)."""
from benchlib import program


def read(trace):
    v = program.view(trace)
    if v is None or not trace.queries or not v.has_node(program.JOINS):
        return None
    return v.node_ms(program.JOINS) / trace.queries
