"""ell_scan_ms (``ell_scan_ms.<cells>``): device milliseconds a static
R-MCL iteration: the device operations launched inside the port's
``rmcl_ell.scan`` spans in the traced window (eager steps and the
captured step's replays) ÷ the iterations those scans ran."""

from portbench import ellspans


def read(rec):
    return ellspans.scan_ms(rec)
