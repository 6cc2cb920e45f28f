"""host.syncs (entry): device-to-host copies a query in the profiler's
trace: the flags' read, row counts, the result columns."""


def read(trace):
    if not trace.queries or not trace.device:
        return None
    return trace.count("memcpy", "DtoH") / trace.queries
