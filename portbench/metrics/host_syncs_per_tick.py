"""Times a decode tick blocks the host on the card: the program's
``host.sync`` spans in the traced slice's decode work, over its ticks
(``portbench/spans.py``)."""

from portbench import spans


def read(rec):
    d = spans.decode(rec)
    return None if d is None else d.per_tick(spans.SYNC)
