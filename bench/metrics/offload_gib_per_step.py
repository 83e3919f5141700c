"""offload_gib_per_step: the bytes that FPDT's host offload moved to the
host and back to the card in the traced steps (``HostOffload``'s
counters), GiB a step."""


def read(trace):
    total = trace.to_host_bytes + trace.to_device_bytes
    return total / 2 ** 30 / trace.steps if total else None
