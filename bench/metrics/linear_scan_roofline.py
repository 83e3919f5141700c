"""linear_scan_roofline: the least time of every recorded linear_scan and
linear_scan_bwd call (each input byte read once, each output written once;
``yardstick.scan_bound``, ``scan_bwd_bound``) over the device time of the
scan kernels, as a share (%)."""
from bench import yardstick as Y


def read(trace):
    t = trace.group_s("linear_scan")
    bound = sum(Y.scan_bound(*c) for c in trace.calls.get("linear_scan", []))
    bound += sum(Y.scan_bwd_bound(*c) for c in trace.calls.get("linear_scan_bwd", []))
    if bound <= 0 or t <= 0:
        return None
    return 100.0 * bound / t
