"""Indexed copies a decode tick issues into the KV cache: the program's
``kv.copies`` counter (``append_kv_stacked``: codes and scales of k and
v, per slot or once for a shared position) in the traced slice's decode
work, over its ticks (``portbench/spans.py``)."""

from portbench import spans


def read(rec):
    d = spans.decode(rec)
    return None if d is None or spans.KV_COPIES not in d.counts \
        else d.per_tick(spans.KV_COPIES)
