"""peak_gib: the most device memory allocated at once in the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
its start), in GiB."""


def read(rec):
    return rec.peak_bytes / 2**30 if rec.peak_bytes else None
