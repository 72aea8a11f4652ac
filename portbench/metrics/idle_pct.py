"""idle_pct (``idle_pct.<cells>``, one name for each end-to-end metric
it moves): the share of the profiled part of the window in which no
device operation ran (the union of the trace's device intervals), in
%."""

from portbench import arith


def read(rec):
    tr = rec.trace
    if tr is None or not tr.window_s:
        return None
    return arith.idle_pct(tr.busy_s, tr.window_s)
