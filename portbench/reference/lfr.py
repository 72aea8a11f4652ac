"""LFR benchmark graphs, host NumPy: A. Lancichinetti, S. Fortunato, F.
Radicchi, "Benchmark graphs for testing community detection algorithms",
Phys. Rev. E 78, 046110 (2008), unweighted and undirected.

The paper's steps, each deterministic from ``seed``:

1. every node draws a degree from a power law of exponent ``tau1`` on
   [k_min, k_max], k_min set so that the mean is ``avg_degree``;
2. community sizes are drawn from a power law of exponent ``tau2`` on
   [``min_community``, ``max_community``] until they hold every node;
3. each node gets the internal degree (1 − ``mu``) · k and is put in a
   community larger than that;
4. the internal stubs are wired within each community and the external
   stubs across the whole graph (configuration model);
5. self loops, multi-edges and external edges that fall inside one
   community are rewired.

Departures from the paper, each also marked where it is made:

* degrees are integers drawn from the discrete power law, and k_min is
  the integer whose discrete mean lies nearest ``avg_degree`` (the rule
  of the authors' own generator): ⟨k⟩ = 20 and k_max = 50 give k_min 10
  and a mean of 19.5;
* an odd degree sum is made even by one node's degree raised by one;
* the internal degree is (1 − μ) · k rounded half up; a community whose
  internal stubs add up to an odd number gives one of them to a member's
  external stubs;
* the sizes drawn past N are cut back, community by community, never
  below ``min_community``;
* a node is placed uniformly at random among the free places of the
  communities large enough for it, the nodes of largest internal degree
  first (the paper reassigns nodes until each fits; this gives the same
  constraint in one pass);
* a bad edge (a self loop, a repeat of an edge, an external edge within
  one community) is rewired by a degree-preserving swap with a random
  good edge of its own kind (internal: of its community), in
  ``SWAP_ROUNDS`` rounds.  An internal edge still bad after them (in a
  community too dense for a swap to find a free pair) gives its two
  stubs to the external side, so every degree stays as drawn and μ rises
  a little (0.3 reads 0.3017 at N = 2^19); an external edge still bad is
  dropped (none was at the sizes and seeds tried).
"""

from __future__ import annotations

import numpy as np

SWAP_ROUNDS = 40


def _pmf(lo: int, hi: int, exponent: float):
    k = np.arange(lo, hi + 1, dtype=np.float64)
    p = k ** (-exponent)
    return k.astype(np.int64), p / p.sum()


def min_degree(avg_degree: float, max_degree: int, tau1: float) -> int:
    """The integer k_min whose discrete power law on [k_min, max_degree]
    has the mean nearest ``avg_degree``."""
    best, gap = 1, np.inf
    for lo in range(1, max_degree + 1):
        k, p = _pmf(lo, max_degree, tau1)
        g = abs(float(k @ p) - avg_degree)
        if g < gap:
            best, gap = lo, g
    return best


def degrees(rng, n: int, avg_degree: float, max_degree: int, tau1: float):
    k, p = _pmf(min_degree(avg_degree, max_degree, tau1), max_degree, tau1)
    deg = rng.choice(k, size=n, p=p)
    if deg.sum() % 2:  # departure: an even degree sum
        deg[rng.choice(np.flatnonzero(deg < max_degree))] += 1
    return deg


def community_sizes(rng, n: int, smin: int, smax: int, tau2: float):
    s, p = _pmf(smin, smax, tau2)
    draw = rng.choice(s, size=n // smin + 1, p=p)
    m = int(np.searchsorted(np.cumsum(draw), n)) + 1
    sizes = draw[:m].copy()
    excess = int(sizes.sum()) - n
    while excess > 0:  # departure: cut back to N, never below smin
        i = rng.choice(np.flatnonzero(sizes > smin))
        cut = min(excess, int(sizes[i]) - smin)
        sizes[i] -= cut
        excess -= cut
    return sizes


def assign(rng, k_in, sizes):
    """Each node's community: one larger than its internal degree, drawn
    uniformly among the free places of such communities, the nodes of
    largest internal degree placed first."""
    n = k_in.shape[0]
    by_size = np.argsort(-sizes, kind="stable")
    slot_comm = np.repeat(by_size, sizes[by_size])
    slot_size = sizes[slot_comm]  # non-increasing: the eligible slots are a prefix
    taken = np.zeros(slot_comm.shape[0], dtype=bool)
    label = np.empty(n, dtype=np.int64)
    for t in np.unique(k_in)[::-1]:
        nodes = np.flatnonzero(k_in == t)
        room = int(np.searchsorted(-slot_size, -t, side="left"))  # slots of size > t
        free = np.flatnonzero(~taken[:room])
        if free.size < nodes.size:
            raise ValueError(f"LFR: {nodes.size} nodes of internal degree {t} and "
                             f"{free.size} free places in communities larger than it")
        pick = rng.choice(free, nodes.size, replace=False)
        taken[pick] = True
        label[nodes] = slot_comm[pick]
    return label


def _keys(u, v, n: int):
    return np.minimum(u, v) * n + np.maximum(u, v)


def _repair(rng, u, v, group, label, n: int, internal: bool):
    """Rewire the bad edges of ``(u, v)`` (sorted by ``group``) by
    degree-preserving swaps with random good edges of the same group:
    returns the good edges and the bad ones left after the last round."""
    u, v = u.copy(), v.copy()

    def valid(a, b):
        ok = a != b
        return ok & (label[a] == label[b]) if internal else ok & (label[a] != label[b])

    keys = _keys(u, v, n)
    order = np.argsort(keys)
    repeat = np.zeros(keys.shape[0], dtype=bool)
    repeat[order[1:]] = keys[order[1:]] == keys[order[:-1]]
    is_bad = ~valid(u, v) | repeat
    bad = np.flatnonzero(is_bad)
    good_keys = np.sort(keys[~is_bad])
    edge = np.flatnonzero(np.diff(group)) + 1  # the groups' bounds
    size = np.diff(np.concatenate([[0], edge, [group.size]]))
    starts = np.repeat(np.concatenate([[0], edge]), size)
    ends = starts + np.repeat(size, size)
    for _ in range(SWAP_ROUNDS):
        if not bad.size:
            break
        b = bad
        p = starts[b] + (rng.random(b.size) * (ends[b] - starts[b])).astype(np.int64)
        ok = ~is_bad[p]
        b, p = b[ok], p[ok]
        both = np.concatenate([b, p])
        uniq, cnt = np.unique(both, return_counts=True)
        twice = uniq[cnt > 1]
        ok = ~np.isin(b, twice) & ~np.isin(p, twice)
        b, p = b[ok], p[ok]
        flip = rng.random(b.size) < 0.5
        a1, b1 = u[b], np.where(flip, v[p], u[p])
        a2, b2 = v[b], np.where(flip, u[p], v[p])
        k1, k2 = _keys(a1, b1, n), _keys(a2, b2, n)

        def absent(k):
            o = np.argsort(k)  # sorted queries search far faster
            i = np.searchsorted(good_keys, k[o])
            out = np.empty(k.size, dtype=bool)
            out[o] = (i >= good_keys.size) | (good_keys[np.minimum(i, good_keys.size - 1)] != k[o])
            return out

        ok = valid(a1, b1) & valid(a2, b2) & (k1 != k2) & absent(k1) & absent(k2)
        new = np.concatenate([k1[ok], k2[ok]])
        uniq, cnt = np.unique(new, return_counts=True)
        clash = uniq[cnt > 1]
        ok &= ~np.isin(k1, clash) & ~np.isin(k2, clash)
        b, p = b[ok], p[ok]
        old = keys[p]
        u[b], v[b], u[p], v[p] = a1[ok], b1[ok], a2[ok], b2[ok]
        keys[b], keys[p] = k1[ok], k2[ok]
        good_keys = np.delete(good_keys, np.searchsorted(good_keys, np.sort(old)))
        add = np.sort(np.concatenate([k1[ok], k2[ok]]))
        good_keys = np.insert(good_keys, np.searchsorted(good_keys, add), add)
        is_bad[b] = False
        bad = bad[is_bad[bad]]
    return u[~is_bad], v[~is_bad], u[is_bad], v[is_bad]


def lfr(n: int, avg_degree: float, max_degree: int, tau1: float, tau2: float, mu: float,
        min_community: int, max_community: int, seed: int):
    """An LFR graph: tight CSR host arrays ``(row_ptr int64[n+1], col
    int64[nnz])``, each edge stored both ways and each row's columns
    sorted, and the planted community of every node (int64[n])."""
    rng = np.random.default_rng([seed, 2008])
    deg = degrees(rng, n, avg_degree, max_degree, tau1)
    k_in = np.floor((1.0 - mu) * deg + 0.5).astype(np.int64)  # departure: half up
    sizes = community_sizes(rng, n, min_community, max_community, tau2)
    label = assign(rng, k_in, sizes)
    # departure: an odd internal stub count gives one stub to the external side
    odd = np.flatnonzero(np.bincount(label, weights=k_in, minlength=sizes.size) % 2 == 1)
    order = rng.permutation(n)
    order = order[np.isin(label[order], odd) & (k_in[order] > 0)]
    _, first = np.unique(label[order], return_index=True)
    k_in[order[first]] -= 1
    k_ext = deg - k_in
    # internal stubs: shuffled within their community, paired in order
    stub = rng.permutation(np.repeat(np.arange(n), k_in))
    stub = stub[np.argsort(label[stub].astype(np.int32), kind="stable")]
    iu, iv = stub[0::2], stub[1::2]
    iu, iv, left_u, left_v = _repair(rng, iu, iv, label[iu], label, n, internal=True)
    # departure: what no swap repaired goes to the external stubs
    k_ext += np.bincount(np.concatenate([left_u, left_v]), minlength=n)
    # external stubs: shuffled over the graph, paired in order
    stub = rng.permutation(np.repeat(np.arange(n), k_ext))
    eu, ev = stub[0::2], stub[1::2]
    eu, ev, _, _ = _repair(rng, eu, ev, np.zeros(eu.size, np.int64), label, n,
                           internal=False)  # departure: what is left is dropped
    u = np.concatenate([iu, eu, iv, ev])
    w = np.concatenate([iv, ev, iu, eu])
    order = np.argsort(u * n + w)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(u, minlength=n), out=row_ptr[1:])
    return row_ptr, w[order], label


def graph(cfg: dict, seed: int | None = None):
    """:func:`lfr` of a configuration (``configs/<name>.json``);
    ``seed`` replaces its generator seed."""
    return lfr(cfg["nodes"], cfg["avg_degree"], cfg["max_degree"], cfg["tau1"], cfg["tau2"],
               cfg["mu"], cfg["min_community"], cfg["max_community"],
               cfg["seed"] if seed is None else seed)
