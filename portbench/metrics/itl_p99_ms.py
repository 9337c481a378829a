"""99th percentile, over every gap in the window, of the time between
two consecutive tokens of one request as the host receives them;
prefills of other slots that land between two ticks count in the gap."""

from portbench import stats


def read(rec):
    p = stats.percentile(rec.window.gaps, 99)
    return None if p is None else p * 1e3
