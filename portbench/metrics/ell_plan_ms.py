"""ell_plan_ms (``ell_plan_ms.<cells>``): host milliseconds a static
R-MCL job spends planning and loading its step: the port's
``rmcl_ell.plan`` (``plan_rmcl_ell``: degree bins, hub union) and
``rmcl_ell.load`` spans (``mt_to_ell``, the hub block, the plan's
uploads) in the traced window ÷ its ``rmcl_ell`` spans (jobs)."""

from portbench import ellspans


def read(rec):
    v = ellspans.view(rec, "rmcl_ell")
    if v is None or not v.named("rmcl_ell.plan"):
        return None
    ms = {k: sum(e - s for _, s, e in v.named(f"rmcl_ell.{k}")) * 1e3 for k in ("plan", "load")}
    jobs = len(v.named("rmcl_ell"))
    rec.notes.append(f"ell_plan_ms: a job {ms['plan'] / jobs:.3f} ms in rmcl_ell.plan, "
                     f"{ms['load'] / jobs:.3f} ms in rmcl_ell.load, over {jobs} jobs")
    return (ms["plan"] + ms["load"]) / jobs
