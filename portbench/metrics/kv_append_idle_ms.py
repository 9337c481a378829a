"""Device-idle time a decode tick that falls inside the self time of the
program's ``kv.append`` spans: the traced slice's idle stretches (no
device operation running) against the host's KV writes, on the trace's
clock through the clock mapping of ``portbench/spans.py``; None when the
mapping is refused."""

from portbench import spans


def read(rec):
    return spans.kv_append_idle_ms(rec)
