"""copy_exposed_ms_per_step: the time of pinned host <-> device copies
during which no compute kernel ran, milliseconds a step."""
from bench import yardstick as Y


def read(trace):
    copies = Y.merged([(s, e) for n, g, s, e in trace.kernels
                       if "memcpy" in n.lower() and "pinned" in n.lower()])
    if not copies:
        return None
    compute = Y.merged([(s, e) for _, g, s, e in trace.kernels if g != "copy"])
    return (Y.length(copies) - Y.overlap(copies, compute)) / 1e3 / trace.steps
