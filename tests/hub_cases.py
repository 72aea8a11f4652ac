"""Hub-row cases for K10 (the ELL-ESC hub's sparse accumulator) and the
sequential Gustavson sum its results are held to: numpy and the port's
CPU constructors only, so the card tests can share them."""

import numpy as np

from sparse_matrix_with_flops_tpu_torch.formats.csr import CSR
from sparse_matrix_with_flops_tpu_torch.ops import ell_esc as E
from sparse_matrix_with_flops_tpu_torch.ops.ell_plan import _flat_layout, plan_ell

# B's columns [CANCEL_LO, ncols) are B row 0's alone, and B row 1 is its
# negative: a hub row that weights rows 0 and 1 alike sums them to 0.0
CANCEL_LO = 29990


def _csr_np(rows, cols, vals, n_rows):
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    rp = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=rp[1:])
    return rp, cols.astype(np.int64), vals.astype(np.float32)


def slabbed_pair(hubs: int, seed: int = 0):
    """Host CSR arrays of A [hubs + 3, 20000] and B [20000, 30000].  Hub
    rows 0 .. hubs - 1 reach 9,000 B rows each, and B has no column in
    [8192, 16384), so some (row, slab) is empty.  With one such row the
    group's union (~9,000 rows) gets 8,192-wide slabs, each two tiles of
    K10, the last one ragged (5,424 columns); with four (~18,000) 4,096-wide
    slabs, the last 1,328.  Those rows weight B rows 0 and 1 alike, and B
    row 1 is B row 0 negated on columns no other B row has, so those sums
    cancel to exactly 0.0.  Row ``hubs`` is a hub row of one entry (B row
    2, 2,000 entries); the last two rows are short."""
    rng = np.random.default_rng(seed)
    k_rows, ncols = 20000, 30000
    # B: rows 0 and 1 on the cancelling columns, row 2 long, the rest
    # three entries each outside slab 1 and the cancelling columns
    allowed = np.r_[np.arange(0, 8192), np.arange(16384, CANCEL_LO)]
    br, bc, bv = [], [], []
    c0 = np.arange(CANCEL_LO, ncols)
    v0 = (rng.integers(1, 9, c0.size) / 8.0) * rng.choice([-1.0, 1.0], c0.size)
    br += [np.zeros(c0.size, np.int64), np.ones(c0.size, np.int64)]
    bc += [c0, c0]
    bv += [v0, -v0]
    c2 = rng.choice(allowed, 2000, replace=False)
    br.append(np.full(c2.size, 2))
    bc.append(c2)
    bv.append(rng.standard_normal(c2.size))
    rest = np.arange(3, k_rows)
    br.append(np.repeat(rest, 3))
    bc.append(np.concatenate([rng.choice(allowed, 3, replace=False) for _ in rest]))
    bv.append(rng.standard_normal(3 * rest.size))
    b = _csr_np(np.concatenate(br), np.concatenate(bc), np.concatenate(bv), k_rows)
    ar, ac, av = [], [], []
    for i in range(hubs):
        cols = np.r_[0, 1, rng.choice(np.arange(3, k_rows), 8998, replace=False)]
        w = rng.standard_normal(cols.size)
        w[1] = w[0]
        ar.append(np.full(cols.size, i))
        ac.append(cols)
        av.append(w)
    ar += [np.array([hubs]), np.array([hubs + 1] * 2), np.array([hubs + 2])]
    ac += [np.array([2]), np.array([7, 9]), np.array([11])]
    av += [np.array([0.75]), rng.standard_normal(2), rng.standard_normal(1)]
    a = _csr_np(np.concatenate(ar), np.concatenate(ac), np.concatenate(av), hubs + 3)
    return a, b, k_rows, ncols


def slabbed_case(hubs: int, device, seed: int = 0):
    """``(a, b, plan)`` of :func:`slabbed_pair` on ``device``, planned
    with the hub on (no column-slab split of hub rows)."""
    (arp, aci, av), (brp, bci, bv), k_rows, ncols = slabbed_pair(hubs, seed)
    a = CSR.from_numpy(arp, aci, av, k_rows, device)
    b = CSR.from_numpy(brp, bci, bv, ncols, device)
    return a, b, plan_ell(a, b, max_w=1024, split_hub=False)


def sequential_row(a_np, b_np, row: int, lo: int, hi: int):
    """Row ``row`` of A·B on columns [lo, hi) as a sequential Gustavson
    sums it: each product rounded to f32 and added in A-entry order from
    0.0, in f32; the nonzero sums as (columns, values)."""
    (arp, aci, av), (brp, bci, bv) = a_np, b_np
    acc = np.zeros(hi - lo, np.float32)
    for e in range(arp[row], arp[row + 1]):
        k = aci[e]
        c, v = bci[brp[k]:brp[k + 1]], bv[brp[k]:brp[k + 1]]
        m = (c >= lo) & (c < hi)
        acc[c[m] - lo] = acc[c[m] - lo] + np.float32(av[e]) * v[m]
    nz = np.flatnonzero(acc)
    return nz + lo, acc[nz]


def hub_regions(plan, flat_c, flat_v, counts):
    """Each hub (row, slab)'s entries in a flat tile stream: a dict
    ``(row, slab) -> (cols, values)`` as host arrays."""
    lay = _flat_layout(plan)
    vst = E._virtual_starts(plan)
    fc, fv, cn = flat_c.cpu().numpy(), flat_v.cpu().numpy(), counts.cpu().numpy()
    out = {}
    for g in plan.hub_groups:
        for r in g.rows:
            for s in range(g.n_slabs):
                vr = int(vst[r]) + s
                o, n = int(lay["flat_base"][vr]), int(cn[vr])
                out[(int(r), s)] = (fc[o:o + n], fv[o:o + n])
    return out
