"""flash_bwd_roofline: the least time of every recorded flash_bwd_dq and
flash_bwd_dkv call (``yardstick.bwd_bound``) over the device time of the
backward kernels (dq, dkv, and dkv's rounding of dO and its split sums),
as a share (%)."""
from bench import yardstick as Y


def read(trace):
    t = trace.group_s("flash_bwd_dq") + trace.group_s("flash_bwd_dkv")
    bound = 0.0
    for which in ("dq", "dkv"):
        for b, hq, hkv, sq, sk, d, nb, qo, ko, win, _ in trace.calls.get(f"flash_bwd_{which}", []):
            bound += Y.bwd_bound(which, b, hq, hkv, sq, sk, d, nb, qo, ko, win)
    if bound <= 0 or t <= 0:
        return None
    return 100.0 * bound / t
