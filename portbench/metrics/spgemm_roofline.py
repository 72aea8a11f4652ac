"""spgemm_roofline (``spgemm_roofline.<cells>``, one name for each
end-to-end metric it moves): the least time C = A·A could take on the
card ÷ the device's busy time a call in the profiled part of the
window, in %.

The least time is the larger of A read once (it is both operands) and
C written once (int32 / float32 CSR) at the card's memory bandwidth,
and 2 · Σ rowFlops at its f32 rate (``peaks.json``): both are of the work the
product needs, whatever engine computes it."""

from portbench import arith


def read(rec):
    tr = rec.trace
    if tr is None or "bytes" not in rec.work or not tr.items:
        return None
    peak = arith.peaks(rec.kind)
    least, bound = arith.least_time(2.0 * rec.work["flops"], rec.work["bytes"], peak)
    per_call = tr.busy_s / tr.items
    rec.notes.append(f"spgemm_roofline: bound by {bound}, least {least * 1e6:.3f} us, "
                     f"device busy {per_call * 1e3:.4f} ms a call over {tr.items} calls")
    return 100.0 * least / per_call
