"""step_ms.cluster: milliseconds an R-MCL iteration: the "step" spans
around ``models.rmcl_ell.rmcl_ell_scan`` / ``models.rmcl.rmcl_scan``,
each ending at a synchronize, ÷ the iterations they ran."""


def read(rec):
    if rec.spans is None or not rec.items or "iters" not in rec.work:
        return None
    s, n = rec.spans.total("step")
    return s * 1e3 / (n * rec.work["iters"]) if n else None
