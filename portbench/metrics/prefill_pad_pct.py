"""Share of the positions the prefill forwards were given that are
padding: counted at the batcher's ``forward_fn`` boundary (positions
given against the real prompt's, which ``last_index`` marks)."""


def read(rec):
    pre = [(B * T, B * real) for B, T, real in rec.window.forwards if T > 1]
    given = sum(g for g, _ in pre)
    return 100.0 * (given - sum(r for _, r in pre)) / given if given else None
