"""sort_ms (``sort_ms.cluster``): device milliseconds an R-MCL iteration
spends in the stream ESC's sort: the device operations launched inside
the port's ``rmcl.step.sort`` spans in the traced window ÷ its
``rmcl.step`` spans (iterations)."""

from portbench import portspans

PHASES = ("expand", "sort", "compress", "prune", "drift")


def read(rec):
    v = portspans.view(rec)
    if v is None or not v.named("rmcl.step"):
        return None
    dev = v.device_s_by_span()
    if "rmcl.step.sort" not in dev:
        return None
    it = len(v.named("rmcl.step"))
    parts = ", ".join(f"{p} {dev.get('rmcl.step.' + p, 0.0) * 1e3 / it:.3f}" for p in PHASES)
    rec.notes.append(f"sort_ms: device ms an iteration by phase over {it} iterations: {parts}")
    return dev["rmcl.step.sort"] * 1e3 / it
