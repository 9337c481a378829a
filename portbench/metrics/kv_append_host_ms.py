"""Host time a decode tick spends writing the INT8 KV cache: the self
time of the program's ``kv.append`` spans (``append_kv_stacked``, its
waits in ``host.sync`` left out) in the traced slice's decode work, over
its ticks (``portbench/spans.py``)."""

from portbench import spans


def read(rec):
    d = spans.decode(rec)
    return None if d is None else d.self_ms(spans.KV_APPEND)
