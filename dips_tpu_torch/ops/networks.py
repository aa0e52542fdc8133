"""Compare-exchange selection networks for exact medians on the VPU.

The reference computes medians with data-dependent bubble sorts inside each
GPU thread (dips/src/gpu/shaders/dips_shader.wgsl:151-166).  Data-dependent
control flow is hostile to the TPU vector unit, so the rebuild replaces each
per-pixel sort with a *fixed* compare-exchange network applied elementwise to
whole tap planes: every comparator is one ``minimum`` + one ``maximum`` over
(H, W) arrays — pure VPU work with no branches.  The network is generated at
trace time and specialised per (window², temporal) size, the TPU-idiomatic
analogue of the reference's WGSL codegen/override specialisation
(dips_alt/src/dips_compute/dynamic_texture_array.rs:10-128).

Construction: Batcher odd-even mergesort for the next power of two, restricted
to the first ``n`` wires (valid because virtual +inf values on wires >= n can
never move down: every comparator sends the max to the higher wire), then
pruned backwards to the comparators that can influence the requested output
positions.  Medians via min/max networks are exact — no floating-point
reassociation is involved.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

# A comparator (i, j): position i receives min, position j receives max.
Comparator = Tuple[int, int]
# A pruned op: (i, j, need_min, need_max).
PrunedOp = Tuple[int, int, bool, bool]


def _batcher_pow2(n: int) -> List[Comparator]:
    """Batcher odd-even mergesort comparators for n a power of two."""
    net: List[Comparator] = []

    def merge(lo: int, cnt: int, r: int) -> None:
        step = r * 2
        if step < cnt:
            merge(lo, cnt, step)
            merge(lo + r, cnt, step)
            for i in range(lo + r, lo + cnt - r, step):
                net.append((i, i + r))
        else:
            net.append((lo, lo + r))

    def sort(lo: int, cnt: int) -> None:
        if cnt > 1:
            m = cnt // 2
            sort(lo, m)
            sort(lo + m, m)
            merge(lo, cnt, 1)

    sort(0, n)
    return net


@functools.lru_cache(maxsize=None)
def sorting_network(n: int) -> Tuple[Comparator, ...]:
    """A sorting network for ``n`` wires (ascending: wire 0 gets the min)."""
    if n <= 1:
        return ()
    p2 = 1
    while p2 < n:
        p2 *= 2
    return tuple((i, j) for (i, j) in _batcher_pow2(p2) if i < n and j < n)


def prune_ops(net: Sequence[Comparator],
              outputs: Tuple[int, ...]) -> Tuple[PrunedOp, ...]:
    """Prune a comparator list to those feeding ``outputs``.

    Walks the network backwards keeping a live-set of wire positions; a
    comparator is kept iff it writes a live wire, and we record whether its
    min and/or max result is actually consumed so the applier can emit a
    single ``minimum``/``maximum`` when only one side is needed.
    """
    live = set(outputs)
    kept: List[PrunedOp] = []
    for (i, j) in reversed(net):
        need_min = i in live
        need_max = j in live
        if not (need_min or need_max):
            continue
        kept.append((i, j, need_min, need_max))
        live.add(i)
        live.add(j)
    kept.reverse()
    return tuple(kept)


@functools.lru_cache(maxsize=None)
def selection_network(n: int, outputs: Tuple[int, ...]) -> Tuple[PrunedOp, ...]:
    """Prune :func:`sorting_network` to comparators feeding ``outputs``."""
    return prune_ops(sorting_network(n), outputs)


@functools.lru_cache(maxsize=None)
def median_network(n: int) -> Tuple[PrunedOp, ...]:
    """Selection network for the pipeline's median convention: index n // 2
    of the ascending order (exact median for odd n, upper median for even n —
    matching ops/oracle.py)."""
    return selection_network(n, (n // 2,))


def apply_network(values: Sequence, ops: Sequence[PrunedOp], minimum, maximum):
    """Apply a pruned network to a list of array-likes; returns a new list.

    ``minimum``/``maximum`` are the binary ops (np.minimum/np.maximum,
    jnp.minimum/jnp.maximum — usable identically under jit, in Pallas kernel
    bodies, and in plain numpy).
    """
    vals = list(values)
    for (i, j, need_min, need_max) in ops:
        a, b = vals[i], vals[j]
        if need_min:
            vals[i] = minimum(a, b)
        if need_max:
            vals[j] = maximum(a, b)
    return vals


def median_of(values: Sequence, minimum, maximum):
    """Exact elementwise median (index n//2 convention) of ``values``."""
    n = len(values)
    if n == 1:
        return values[0]
    out = apply_network(values, median_network(n), minimum, maximum)
    return out[n // 2]


# ---------------------------------------------------------------------------
# Column-factored window medians: shared column sorts + pruned merge tree.
#
# A w*w window median over shifted planes can reuse the *vertical* sorts:
# sorting the w row-shifted planes once gives, at every pixel, the sorted
# column of each horizontal offset simultaneously (shifts commute with
# elementwise sorting).  The per-window work is then only a merge network of
# w sorted columns, pruned to the median output — the construction behind
# the classic 19-comparator median-of-9, generalised to any odd w.
# ---------------------------------------------------------------------------

def _merge_runs(a: List[int], b: List[int],
                ops: List[Comparator]) -> List[int]:
    """Batcher odd-even merge of two sorted runs of wire indices (arbitrary
    lengths).  Appends comparators to ``ops``; returns the wire order of the
    merged run (ascending)."""
    if not a:
        return list(b)
    if not b:
        return list(a)
    if len(a) == 1 and len(b) == 1:
        ops.append((a[0], b[0]))
        return [a[0], b[0]]
    c = _merge_runs(a[0::2], b[0::2], ops)   # merge the evens
    d = _merge_runs(a[1::2], b[1::2], ops)   # merge the odds
    # Interleave: result starts with c[0]; then each d[j] is compare-
    # exchanged with c[j+1]; leftovers keep their order (Knuth 5.3.4).
    r = [c[0]]
    j = 0
    for i in range(1, len(c)):
        if j < len(d):
            ops.append((d[j], c[i]))
            r.append(d[j])
            r.append(c[i])
            j += 1
        else:
            r.append(c[i])
    r.extend(d[j:])
    return r


def _validate_merge(ops: Sequence[Comparator], a: List[int], b: List[int],
                    order: List[int]) -> None:
    """Exhaustive 0-1 check (complete by the 0-1 principle for merges)."""
    wires = sorted(set(a) | set(b))
    for za in range(len(a) + 1):
        for zb in range(len(b) + 1):
            vals = {w: 0 for w in wires}
            for k, wi in enumerate(a):
                vals[wi] = 0 if k < za else 1
            for k, wi in enumerate(b):
                vals[wi] = 0 if k < zb else 1
            for (i, j) in ops:
                lo, hi = min(vals[i], vals[j]), max(vals[i], vals[j])
                vals[i], vals[j] = lo, hi
            got = [vals[w] for w in order]
            if got != sorted(got):
                raise AssertionError(
                    f"merge network failed for runs {len(a)},{len(b)}")


def _merge_tree_shapes(k: int):
    """Binary merge-tree shapes over k identical leaves (None = leaf),
    up to mirror symmetry (left <= right splits only — comparator/unit
    counts are mirror-invariant, so the cost-model ranking is complete;
    mirror ORDERS can differ on silicon and are covered by the measured
    `_MEASURED_SHAPES` pins, not this search)."""
    if k == 1:
        yield None
        return
    for left in range(1, k // 2 + 1):
        for a in _merge_tree_shapes(left):
            for b in _merge_tree_shapes(k - left):
                yield (a, b)


def _build_median_plan(w: int, shape, validate: bool
                       ) -> Tuple[Tuple[PrunedOp, ...], int]:
    """Build the pruned merge plan for one merge-tree ``shape``.

    Each internal node Batcher-merges its children's sorted runs, then
    applies rank-bounded truncation: position r of a subtree run that has
    already dropped ``dr`` provably-below-median wires has exactly r + dr
    subtree elements below it and q = n - cnt wires of unknown order
    outside the subtree; it can be the global median (rank n//2) only if
    r + dr <= target <= r + dr + q.  Below-band drops are provably below
    the median (counted in dr); above-band drops are provably above and
    simply forgotten.
    """
    n = w * w
    target = n // 2
    cols = iter(range(w))
    ops: List[Comparator] = []

    def build(s):
        if s is None:
            dx = next(cols)
            return [dx * w + j for j in range(w)], w, 0
        a, ca, da = build(s[0])
        b, cb, db = build(s[1])
        start = len(ops)
        m = _merge_runs(a, b, ops)
        if validate:
            _validate_merge(ops[start:], a, b, m)
        cnt, dr = ca + cb, da + db
        q = n - cnt
        lo = max(0, target - dr - q)
        hi = min(len(m) - 1, target - dr)
        return m[lo:hi + 1], cnt, dr + lo

    merged, cnt, dropped = build(shape)
    assert cnt == n and len(merged) == 1 and dropped == target
    return prune_ops(ops, (merged[0],)), merged[0]


def _plan_units(pruned: Sequence[PrunedOp]) -> int:
    """VPU cost model: one unit per emitted min or max."""
    return sum(int(nm) + int(nx) for _, _, nm, nx in pruned)


# Merge-tree shapes chosen by ON-CHIP measurement across the op-count
# Pareto set (v5e, 1080p full pipeline, bench.py --window W): op count
# alone does not predict Mosaic's scheduling quality — the fully balanced
# w=7 tree has the fewest units (312) but measured 1,635 fps vs the
# left-deep chain's 2,034, while this 320-unit hybrid (balanced interior,
# single-column top spine) measured 2,285 fps.  w=5: balanced 98-unit tree
# measured 4,821 fps vs left-deep 4,367.  (None = a column leaf.)
_MEASURED_SHAPES = {
    # w=3 has one 16-unit plan either way, but the ((c0,c1),c2) wire order
    # measured 11.4k fps vs 10.1k for (c0,(c1,c2)) — keep the faster order
    3: ((None, None), None),
    5: (None, ((None, None), (None, None))),
    7: (None, (None, ((None, None), (None, (None, None))))),
}


@functools.lru_cache(maxsize=None)
def column_median_plan(w: int) -> Tuple[Tuple[Comparator, ...],
                                        Tuple[PrunedOp, ...], int]:
    """Plan for an exact w*w window median with shared column sorts.

    Returns (column_sort, merge_ops, target_wire):
      * ``column_sort``: full sort of the w vertical taps — applied ONCE per
        plane, its outputs shared by every horizontal shift;
      * ``merge_ops``: pruned comparators over w*w wires (wire dx*w + j =
        j-th smallest of the column at horizontal offset dx) computing the
        median into ``target_wire``.

    The merge-tree SHAPE comes from ``_MEASURED_SHAPES`` (on-chip-measured
    winners over the op-count Pareto set; see the table there) and falls
    back to an exhaustive search over all binary trees for the fewest
    min/max units after rank truncation + backward pruning.  Every
    constituent merge of the chosen plan is validated exhaustively on 0-1
    inputs (complete by the 0-1 principle).
    """
    if w in _MEASURED_SHAPES:
        best_shape = _MEASURED_SHAPES[w]
    else:
        ranked = sorted(
            ((_plan_units(_build_median_plan(w, s, validate=False)[0]), i,
              s) for i, s in enumerate(_merge_tree_shapes(w))),
            key=lambda r: r[:2])
        best_shape = ranked[0][2]
    pruned, out_wire = _build_median_plan(w, best_shape, validate=True)
    return sorting_network(w), pruned, out_wire


def rank_select(values: Sequence, rank: int, minimum, maximum):
    """Exact elementwise ``rank``-th smallest (0-indexed) of ``values``
    via a pruned selection network (same machinery as :func:`median_of`,
    arbitrary output rank)."""
    n = len(values)
    if n == 1:
        return values[0]
    out = apply_network(values, selection_network(n, (rank,)),
                        minimum, maximum)
    return out[rank]


def quirk_window_select(vertical_taps: Sequence, shift, minimum, maximum):
    """The reference ``dips`` crate's spatial filter, bug-for-bug
    (``DiPsProperties.quirk_compat``; dips/src/gpu/shaders/
    dips_shader.wgsl:122-170 and the identical pre_compute_shader.wgsl
    copy): an off-center ``(w-1) x (w-1)`` window (the loops iterate
    ``[-w/2, w/2)``), sorted together with the ``2w`` structural zeros its
    zero-initialised 121-slot ``median_array`` contributes (the
    ``w*w - (w-1)^2 = 2w - 1`` never-written slots plus the in-bounds slot
    ``w*w`` that the bubble sort's ``j + 1`` read drags into the prefix),
    picked at index ``(w*w)/2 + 1``.

    Every tap is a non-negative intensity, so the zeros occupy the low
    ranks of the sorted prefix and the pick reduces to rank
    ``(w*w)//2 + 1 - 2w`` of the taps alone — negative at w=3, where the
    reference's "median filter" is therefore constantly zero.

    Args:
      vertical_taps: ``w - 1`` planes, plane j = input shifted down by
        ``j - w//2`` (vertical offsets ``-p .. p-1``, i.e. ``[-p, p)``).
      shift: as :func:`window_median`; horizontal offsets are ``[-p, p)``.
    """
    wm1 = len(vertical_taps)
    w = wm1 + 1
    p = w // 2
    rank = (w * w) // 2 + 1 - 2 * w
    if rank < 0:  # w == 3: the structural zeros cover the picked index
        z = shift(vertical_taps[0], 0)  # shift(..., 0) = output-shaped view
        return z - z
    wires = [shift(vt, dx - p) for dx in range(wm1) for vt in vertical_taps]
    return rank_select(wires, rank, minimum, maximum)


def separable_median(vertical_taps: Sequence, shift, minimum, maximum):
    """Separable approximation of the w*w window median: exact median down
    each column (one selection network, shared by every pixel), then the
    exact median across the w horizontal offsets of that column-median
    plane.  ~2 median-of-w networks + (w-1) shifts instead of the full
    merge tree — at w=7 that is 28 comparators + 6 shifts vs the exact
    plan's ~350 comparators + 42 shifts.  The result is always one of the
    window's own values, with provable rank bounds: at least
    ceil(w/2)^2 window values are <= it and at least ceil(w/2)^2 are >= it
    (rank within [16, 34] of 49 at w=7; the true median is 25) — in
    practice within a few greylevels of the true median on natural images
    (measured in docs/DESIGN.md)."""
    w = len(vertical_taps)
    if w == 1:
        return vertical_taps[0]
    colmed = median_of(list(vertical_taps), minimum, maximum)
    p = w // 2
    return median_of([shift(colmed, dx - p) for dx in range(w)],
                     minimum, maximum)


def window_median(vertical_taps: Sequence, shift, minimum, maximum):
    """Exact w*w window median from w vertical-shift planes.

    Args:
      vertical_taps: w planes, plane j = input shifted down by (j - w//2).
      shift: callable (plane, dx) -> plane shifted left by dx (dx in
        [-w//2, w//2]); boundary semantics are the caller's.
    """
    w = len(vertical_taps)
    if w == 1:
        return vertical_taps[0]
    col_sort, merge_ops, target = column_median_plan(w)
    sv = apply_network(list(vertical_taps),
                       [(i, j, True, True) for i, j in col_sort],
                       minimum, maximum)
    p = w // 2
    wires = [shift(sv[j], dx - p) for dx in range(w) for j in range(w)]
    out = apply_network(wires, merge_ops, minimum, maximum)
    return out[target]
