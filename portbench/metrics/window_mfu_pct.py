"""The least time the H100 needs for every forward the window ran, over
the window's time. A decode tick counts the slots that serve a request
(the weights, the head and the KV they attend, each read once, against
their int8 products and attention); a prefill counts its real prompt
tokens with the head on one row. Counted from the configuration's
shapes (``counts.py``), so it holds whatever kernels do the work."""

from portbench import counts


def read(rec):
    if rec.window_s <= 0:
        return None
    least = sum(counts.decode_forward_s(rec.lm, pos)
                for d in rec.window.dispatches for pos in d.positions)
    least += sum(counts.prefill_forward_s(rec.lm, n)
                 for _, _, n in rec.window.submits)
    return 100.0 * least / rec.window_s
