"""pad_ms (``pad_ms.cluster``): host milliseconds a job spends in the
R-MCL capacity pad, the port's ``rmcl.pad`` spans in the traced window
(``CSR.with_capacity``: the first iterate read to the host, padded there
and copied back to the card from pageable memory) ÷ the jobs traced."""

from portbench import portspans


def read(rec):
    v = portspans.view(rec)
    if v is None or not v.named("rmcl.pad"):
        return None
    ms = {}
    for name in ("rmcl.pad", "read.csr.to_numpy", "write.csr.from_numpy"):
        ms[name] = sum(e - s for _, s, e in v.named(name)) * 1e3 / v.items
    up = sum(r.nbytes for r, _, _ in v.named("write.csr.from_numpy")) / v.items
    rec.notes.append(f"pad_ms: a job {ms['rmcl.pad']:.3f} ms in the pad, of it "
                     f"{ms['read.csr.to_numpy']:.3f} ms reading the iterate and "
                     f"{ms['write.csr.from_numpy']:.3f} ms copying {up / 1e6:.1f} MB back")
    return ms["rmcl.pad"]
