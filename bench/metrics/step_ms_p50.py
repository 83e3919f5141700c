"""step_ms_p50: the median host-clock milliseconds of the window's steps,
as the step loop times them (``TrainLoop``'s ``dt``: a step's work up to
its device synchronise)."""
import statistics


def read(trace):
    if not trace.window_dts:
        return None
    return 1e3 * statistics.median(trace.window_dts)
