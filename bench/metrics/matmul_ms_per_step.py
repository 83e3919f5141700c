"""matmul_ms_per_step: device time of the cuBLAS matrix products,
milliseconds a step."""


def read(trace):
    t = trace.group_s("matmul")
    return 1e3 * t / trace.steps if t > 0 else None
