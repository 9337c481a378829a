"""Host time a decode tick spends waiting on the card: the program's
``host.sync`` spans (a blocking copy onto the card, or a read of a
device result) in the traced slice's decode work, over its ticks
(``portbench/spans.py``)."""

from portbench import spans


def read(rec):
    d = spans.decode(rec)
    return None if d is None else d.total_ms(spans.SYNC)
