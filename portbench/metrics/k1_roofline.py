"""K1's share of its roofline in the traced slice: the least time of the
K1 launches the slice's forwards made (bytes of weight codes, f32 x and
output and scales, each once a launch, against the int8 peak;
``counts.k1_launch``) over K1's device time. K1 is the stacked decode
product (``kernels/stacked.py``, ``csrc/stacked_i8.cu``), whose device
kernel is ``i8_stream_kernel``. Every forward of at most ``k1_max_m``
rows runs it at each site of each layer. If the trace lost some of its
events, the time is scaled up by launches expected over launches seen."""

from portbench import counts

KERNEL = r"i8_stream_kernel"


def read(rec):
    if rec.slice is None:
        return None
    launches = byts = ops = 0
    for B, T, _ in rec.traced.forwards:
        if B * T <= rec.k1_max_m:
            n, b, o = counts.k1_forward(rec.lm, B * T)
            launches, byts, ops = launches + n, byts + b, ops + o
    secs, seen = rec.slice.matching(KERNEL)
    if not launches or not seen:
        return None
    return 100.0 * counts.bound_s(byts, ops) / (secs * launches / seen)
