"""90th percentile, over every request whose first token arrived in the
window, of the time from its submission (the moment its caller received
its previous reply) to its first token on the host."""

from portbench import stats


def read(rec):
    p = stats.percentile(rec.window.ttft, 90)
    return None if p is None else p * 1e3
