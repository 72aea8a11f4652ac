"""cluster_ms: the window's milliseconds ÷ the jobs completed in it, each
job a graph on the card taken to its clustering."""


def read(rec):
    if "iters" not in rec.work or not rec.items:
        return None
    return rec.window_s * 1e3 / rec.items
