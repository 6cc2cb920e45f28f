"""ops.launches (operators and expressions): device kernel launches a query,
of every kernel, the program's own and the libraries'."""


def read(trace):
    if not trace.queries or not trace.device:
        return None
    return trace.count("kernel") / trace.queries
