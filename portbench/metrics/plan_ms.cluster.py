"""plan_ms.cluster: host milliseconds a job spends in the R-MCL planners
(the "plan" spans the traced run puts around
``models.rmcl_ell.plan_rmcl_ell`` and ``models.rmcl.plan_capacities``)."""


def read(rec):
    if rec.spans is None or not rec.items:
        return None
    s, n = rec.spans.total("plan")
    return s * 1e3 / rec.items if n else None
