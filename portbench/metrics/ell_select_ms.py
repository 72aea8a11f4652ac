"""ell_select_ms (``ell_select_ms.<cells>``): device milliseconds an
eagerly run static R-MCL step spends in the top-S selection: the device
operations launched inside the port's ``rmcl_ell.step.select`` spans
(``_prune_select_lanes``: inflate, threshold, two stable sorts over the
tile, renormalise) ÷ its ``rmcl_ell.step`` spans.  Its note gives the
other phases (gather, tile, hub, drift)."""

from portbench import ellspans


def read(rec):
    return ellspans.phase_ms(rec, "select", "ell_select_ms")
