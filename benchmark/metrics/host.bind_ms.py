"""host.bind_ms (entry): host-clock ms a query in ``compile_plan``, the
bind of the plan, timed by the benchmark's span around the call."""


def read(trace):
    if not trace.queries or "bind" not in trace.host_s:
        return None
    return trace.host_s["bind"] * 1e3 / trace.queries
