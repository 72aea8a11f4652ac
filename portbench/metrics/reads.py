"""reads (``reads.<cells>``, one name for each end-to-end metric it
moves): the port's reads from the card (``utils.timing.TRACE.host_read``,
the counter ``reads``) in the traced window ÷ the jobs or calls traced.

Its note names each read by site, the device's idle time by the
innermost port span the host was in, the device time by the port span
that launched it, and the clock check of the port's spans."""

from collections import Counter

from portbench import portspans


def read(rec):
    v = portspans.view(rec)
    if v is None:
        return None
    n = v.items
    sites = Counter(r.name for r, _, _ in v.spans if r.name.startswith("read."))
    rec.notes.append("reads by site, a job or call: "
                     + ", ".join(f"{k[5:]} {c / n:g}" for k, c in sorted(sites.items())))
    rows, inside = v.idle_by_span()
    rec.notes.append(f"idle by port span ({100 * inside:.1f}% of the idle time inside one): "
                     + "; ".join(f"{lab} {t:.6f} s" for lab, t in rows))
    dev = sorted(v.device_s_by_span().items(), key=lambda x: -x[1])[:10]
    rec.notes.append("device time by launching port span: "
                     + "; ".join(f"{lab} {t:.6f} s" for lab, t in dev))
    cc = v.clock_check()
    worst = max(cc["copy_outside_read_s"], cc["op_after_read_s"])
    rec.notes.append(f"clock check over {cc['reads']} reads (offset {v.origin:.6f} s): copy "
                     f"outside its read {cc['copy_outside_read_s'] * 1e6:.1f} us, an operation "
                     f"ending after its read {cc['op_after_read_s'] * 1e6:.1f} us; "
                     f"{'holds' if worst <= portspans.TOL_S else 'FAILS'} to "
                     f"{portspans.TOL_S * 1e6:.0f} us")
    return v.reads / n
