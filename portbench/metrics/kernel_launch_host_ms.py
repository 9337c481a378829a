"""Host time a decode tick spends in the hand-written kernels' wrappers
(operand checks, plan, the ctypes launch): the self time of the
program's ``kernel.launch`` spans (K1, K3, K4, K6 in
``kernels/stacked.py``; K2, K7 in ``kernels/attention.py``) in the
traced slice's decode work, over its ticks (``portbench/spans.py``)."""

from portbench import spans


def read(rec):
    d = spans.decode(rec)
    return None if d is None else d.self_ms(spans.LAUNCH)
