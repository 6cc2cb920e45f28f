"""ops.join_kept_mrows (operators and expressions): millions of rows a
query that the joins which compact their output keep and hand on: the
``rows`` of their ``sync.join.num_rows`` spans, summed over the window and
divided by the queries.  None where the program opens no such span."""
from benchlib import program


def read(trace):
    v = program.view(trace)
    if v is None or not trace.queries:
        return None
    rows = [s[5]["rows"] for s in v.spans
            if s[0] == "sync.join.num_rows" and "rows" in s[5]]
    if not rows:
        return None
    return sum(rows) / trace.queries / 1e6
