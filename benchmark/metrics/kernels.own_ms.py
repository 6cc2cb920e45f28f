"""kernels.own_ms (kernels): device ms a query in the program's own kernels
(the ``__global__`` functions of its ``csrc`` sources)."""


def read(trace):
    if not trace.queries or not trace.device:
        return None
    return trace.device_ms(("kernel",), own=True) / trace.queries
