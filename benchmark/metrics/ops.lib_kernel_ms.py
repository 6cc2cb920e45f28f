"""ops.lib_kernel_ms (operators and expressions): device ms a query in
activity that the program did not write (ATen, cub, thrust kernels, memset
and memcpy)."""


def read(trace):
    if not trace.queries or not trace.device:
        return None
    return (trace.device_ms(("kernel",), own=False)
            + trace.device_ms(("memcpy", "memset"))) / trace.queries
