"""elementwise_ms_per_step: device time of the kernels outside the named
groups (PyTorch's elementwise and reduction kernels: norms, activations,
the selective scan's chain, the loss, AdamW), milliseconds a step."""


def read(trace):
    t = trace.group_s("other")
    return 1e3 * t / trace.steps if t > 0 else None
