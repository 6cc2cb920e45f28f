"""ops.agg_sort_mrows (operators and expressions): millions of rows a
query that the sort-path group-by sorts: the live rows it reads the count
of, the ``rows`` of its ``sync.agg.num_rows`` spans, summed over the window
and divided by the queries.  None where the program opens no such span."""
from benchlib import program


def read(trace):
    v = program.view(trace)
    if v is None or not trace.queries:
        return None
    rows = [s[5]["rows"] for s in v.spans
            if s[0] == "sync.agg.num_rows" and "rows" in s[5]]
    if not rows:
        return None
    return sum(rows) / trace.queries / 1e6
