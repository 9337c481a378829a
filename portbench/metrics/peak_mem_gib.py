"""``torch.cuda.max_memory_allocated()`` from before the weights are
made to the end of the window, in GiB."""


def read(rec):
    return rec.memory_peak_bytes / 2 ** 30 if rec.memory_peak_bytes else None
