"""Host time of every ``submit`` in the window (each prefills one prompt
and returns after its first token is read back), per thousand real
prompt tokens."""


def read(rec):
    subs = rec.window.submits
    toks = sum(n for _, _, n in subs)
    return sum(t1 - t0 for t0, t1, _ in subs) * 1e3 / (toks / 1e3) \
        if toks else None
