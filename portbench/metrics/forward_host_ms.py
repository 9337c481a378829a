"""Host time a decode tick spends in ``engine.forward`` outside its
child spans: the eager torch ops (embedding, LayerNorms, bias adds and
casts, activations, residuals). The self time of the program's
``engine.forward`` spans in the traced slice's decode work, over its
ticks (``portbench/spans.py``)."""

from portbench import spans


def read(rec):
    d = spans.decode(rec)
    return None if d is None else d.self_ms(spans.FORWARD)
