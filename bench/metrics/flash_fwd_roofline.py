"""flash_fwd_roofline: the least time of every recorded flash_fwd call
(``yardstick.call_bound``) over the device time of the flash_fwd kernels,
as a share (%)."""
from bench import yardstick as Y


def read(trace):
    t = trace.group_s("flash_fwd")
    calls = trace.calls.get("flash_fwd", [])
    if not calls or t <= 0:
        return None
    bound = sum(Y.call_bound(b, hq, hkv, sq, sk, d, nb, qo, ko, carry, win)
                for b, hq, hkv, sq, sk, d, nb, qo, ko, win, carry in calls)
    return 100.0 * bound / t
