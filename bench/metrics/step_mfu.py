"""step_mfu: the model FLOPs of one step over the median step time of the
window, as a share of the chip's bf16 peak (%): the whole step's share,
which bounds every kernel's gain."""
import statistics

from bench import yardstick as Y


def read(trace):
    if not trace.window_dts:
        return None
    dt = statistics.median(trace.window_dts)
    return 100.0 * trace.step_flops / (dt * Y.PEAK_BF16_FLOPS * trace.cell.chips)
