"""gflops (``gflops.<cells>``, split by cell so that each keeps a bound
of its own): 2 · Σ rowFlops(A·A) (multiply and add, perfTests/only-somp.cc)
× the calls completed in the window ÷ the window's seconds, in GFLOP/s."""


def read(rec):
    if "flops" not in rec.work or not rec.window_s:
        return None
    return 2.0 * rec.work["flops"] * rec.items / rec.window_s / 1e9
