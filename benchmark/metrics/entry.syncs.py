"""entry.syncs (entry): device-to-host transfers a query in the program's
``sync.<site>`` spans (the flags' read, row counts, the result columns and
every sync inside the plan), the inside twin of host.syncs."""
from benchlib import program


def read(trace):
    v = program.view(trace)
    if v is None or not trace.queries or not trace.device:
        return None
    return sum(s[5].get("transfers", 0) for s in v.spans
               if s[0].startswith("sync.")) / trace.queries
