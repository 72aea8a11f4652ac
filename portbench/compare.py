"""The numbers that decide ``correct``: the program's result against the
plain reference's, on the card after the window.

Each function returns ``{name: value}``; a cell's limits
(``limits/<cell>.json``) say which of them are held, and to what.
"""

from __future__ import annotations

import torch


def _rows(row_ptr):
    n = row_ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=row_ptr.device),
                                   row_ptr[1:] - row_ptr[:-1])


def tight(row_ptr, col, val):
    """A CSR of the program (int32, padded to its capacity) as tight
    int64 / float64 tensors."""
    rp = row_ptr.long()
    nnz = int(rp[-1])
    return rp, col[:nnz].long(), val[:nnz].double()


def _keys(row_ptr, col, n: int):
    """Entry keys row · (n + 1) + col: a column clamped to n (out of
    range) matches no entry of a valid CSR."""
    return _rows(row_ptr) * (n + 1) + col.clamp(0, n)


def _merge(n, p_rp, p_ci, p_v, r_rp, r_ci, r_v):
    """Both patterns merged: per key (:func:`_keys`) the program's value
    minus the reference's, the reference's value, and how many sides hold
    it."""
    key = torch.cat([_keys(p_rp, p_ci, n), _keys(r_rp, r_ci, n)])
    val = torch.cat([p_v, -r_v.double()])
    ref = torch.cat([torch.zeros_like(p_v), r_v.double()])
    key, order = torch.sort(key)
    ukey, inv, cnt = torch.unique_consecutive(key, return_inverse=True, return_counts=True)
    diff = torch.zeros(ukey.shape[0], dtype=torch.float64, device=key.device)
    diff.index_add_(0, inv, val[order])
    rval = torch.zeros_like(diff).index_add_(0, inv, ref[order])
    return ukey, cnt, diff, rval


def spgemm_numbers(program, reference, absolute, ncols: int, block: int = 1 << 26) -> dict:
    """C of the program ``(row_ptr, col, val)`` against the reference's C
    and |A|·|B| (the reference's product of absolute values, on its
    pattern).  ``pattern_diff``: entries in one pattern only;
    ``rel_err``: the largest |c − c_ref| / (|A|·|B|) over the entries of
    both.  Rows go in blocks of at most about ``block`` entries a side,
    so that a product of hundreds of millions of entries fits beside
    its reference."""
    p_rp = program[0].long()
    r_rp, r_ci, r_v = reference
    n = r_rp.shape[0] - 1
    pattern_diff, rel_err = 0, 0.0
    r0 = 0
    while r0 < n:
        end = max(int(p_rp[r0]), int(r_rp[r0])) + block
        r1 = min(int(torch.searchsorted(p_rp, end, right=True)),
                 int(torch.searchsorted(r_rp, end, right=True))) - 1
        r1 = min(max(r1, r0 + 1), n)
        pb, pe, rb, re = int(p_rp[r0]), int(p_rp[r1]), int(r_rp[r0]), int(r_rp[r1])
        p_part = (p_rp[r0:r1 + 1] - pb, program[1][pb:pe].long(), program[2][pb:pe].double())
        r_part = (r_rp[r0:r1 + 1] - rb, r_ci[rb:re], r_v[rb:re])
        ukey, cnt, diff, _ = _merge(ncols, *p_part, *r_part)
        both = cnt == 2
        scale = absolute[2][rb:re].double()[torch.searchsorted(
            _keys(r_part[0], r_part[1], ncols), ukey[both])]
        rel = diff[both].abs() / torch.clamp(scale, min=1e-30)
        pattern_diff += int((cnt != 2).sum())
        if rel.numel():
            rel_err = max(rel_err, float(rel.max()))
        r0 = r1
    return {"pattern_diff": pattern_diff, "rel_err": rel_err}


def rmcl_numbers(program, reference, n: int) -> dict:
    """A final R-MCL iterate of the program ``(row_ptr, col, val)``
    against the reference's.

    * ``bad_rows``: rows of the program that are no iterate row: columns
      not strictly increasing or out of range, a value not finite or not
      above 0;
    * ``rowsum_gap``: the largest |Σ row − 1| (an empty row reads 1);
    * ``rows_apart``: the share of rows whose kept columns differ from
      the reference's (threshold flips and ties at the S cut);
    * ``gap_p99`` / ``gap_max``: the 99th percentile and the largest of
      the rows' L1 distances from the reference's rows;
    * ``err_matched``: the largest |v − v_ref| / v_ref on the rows whose
      kept columns agree."""
    p_rp, p_ci, p_v = tight(*program)
    r_rp, r_ci, r_v = reference
    dev = p_v.device
    pr = _rows(p_rp)
    same_row = pr[1:] == pr[:-1]
    bad = torch.zeros(n, dtype=torch.bool, device=dev)
    bad[pr[1:][same_row & (p_ci[1:] <= p_ci[:-1])]] = True
    bad[pr[(p_ci < 0) | (p_ci >= n) | ~torch.isfinite(p_v) | (p_v <= 0)]] = True
    rowsum = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(0, pr, p_v)
    ukey, cnt, diff, rval = _merge(n, p_rp, p_ci, p_v, r_rp, r_ci, r_v)
    urow = ukey // (n + 1)
    apart = torch.zeros(n, dtype=torch.bool, device=dev)
    apart[urow[cnt != 2]] = True
    gap = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(0, urow, diff.abs())
    g = torch.sort(gap).values
    matched = ~apart[urow]
    err = diff[matched].abs() / torch.clamp(rval[matched], min=1e-300)
    return {
        "bad_rows": int(bad.sum()),
        "rowsum_gap": float((rowsum - 1.0).abs().max()),
        "rows_apart": float(apart.sum()) / n,
        "gap_p99": float(g[min(int(0.99 * (n - 1) + 0.5), n - 1)]),
        "gap_max": float(g[-1]),
        "err_matched": float(err.max()) if err.numel() else 0.0,
    }
