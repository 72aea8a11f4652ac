"""ell_step_roofline (``ell_step_roofline.<cells>``): the least time of a
static R-MCL iteration ÷ its device time (``ell_scan_ms``), in %.

The least time is the larger of two counts of the step's products,
nnz(Mgt) · S of them (``work``: the benchmark's own count, whatever
implements the step): each an (int32 column, f32 value) pair written
once and read once, 16 bytes, at the card's memory bandwidth; and 2
flops each (multiply and add) at its f32 rate (``peaks.json``)."""

from portbench import arith, ellspans

PAIR_BYTES = 8  # an int32 column and an f32 value


def step_counts(work: dict) -> tuple[float, float]:
    """(flops, bytes) of one step: nnz(Mgt) · S products, 2 flops and a
    pair written and read (2 · ``PAIR_BYTES``) each."""
    products = work["products"] / work["iters"]
    return 2.0 * products, 2.0 * PAIR_BYTES * products


def read(rec):
    ms = ellspans.scan_ms(rec)
    if ms is None or "products" not in rec.work:
        return None
    flops, nbytes = step_counts(rec.work)
    least, bound = arith.least_time(flops, nbytes, arith.peaks(rec.kind))
    rec.notes.append(f"ell_step_roofline: bound by {bound}, least {least * 1e3:.4f} ms, "
                     f"device {ms:.4f} ms an iteration")
    return 100.0 * least * 1e3 / ms
