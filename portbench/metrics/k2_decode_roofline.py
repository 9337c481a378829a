"""K2's decode share of its roofline in the traced slice: the least time
of the decode ticks' attention (each serving slot's positions 0..p read
once with q and the output, against the bf16 peak;
``counts.k2_decode_layer``) over K2's decode device time. Slots that
serve no request decode garbage and count for nothing. K2's decode
regime (``kernels/attention.py``, ``csrc/int8_kv_attention_split.cu``)
is two device kernels a layer, ``split_kernel`` and ``combine_kernel``;
if the trace lost some split events, the time is scaled up by launches
expected over launches seen."""

from portbench import counts

SPLIT = r"\bsplit_kernel<"
KERNELS = r"\b(split_kernel|combine_kernel)<"


def read(rec):
    if rec.slice is None:
        return None
    L = rec.lm["n_layers"]
    ticks = byts = ops = 0
    for d in rec.traced.dispatches:
        for pos in d.positions:
            ticks += 1
            b, o = counts.k2_decode_layer(rec.lm, pos)
            byts, ops = byts + L * b, ops + L * o
    secs, _ = rec.slice.matching(KERNELS)
    _, seen = rec.slice.matching(SPLIT)
    if not ticks or not seen or not byts:
        return None
    return 100.0 * counts.bound_s(byts, 0, ops) / (secs * ticks * L / seen)
