"""Every output token the host received in the window, over the window's
seconds (first tokens from ``submit`` and every tick's tokens)."""

from portbench import stats


def read(rec):
    return stats.rate(rec.window.tokens, rec.window_s)
