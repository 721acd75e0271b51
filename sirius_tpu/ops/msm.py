"""Multi-scalar multiplication kernels (device).

Device replacement for halo2curves `best_multiexp` (reference
`src/commitment.rs:81-90`; SURVEY.md §2.8 item 2).  Instead of the CPU
Pippenger's sequential bucket pushes, a fully data-parallel formulation with
ALL windows processed as one batched axis (wide vectors, one XLA program,
no per-window loop):

  digits        (W, n)  c-bit slices of the scalar limbs
  sort          batched argsort -> contiguous bucket segments per window
  segment sums  batched segmented inclusive scan (Hillis-Steele fori_loop:
                log n iterations of one batched complete-EC-add body)
  bucket table  per-window searchsorted gather of segment tails
  window totals sum_v v * B_v via batched suffix scans
  combine       Horner over windows (c doublings + 1 add per window)

Work is n*log n EC adds (the Hillis-Steele trade-off: a compile-friendly,
fusion-friendly single program); the work-efficient merge path that reaches
classic Pippenger's ~n adds is the bucket-table kernel below.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..curves.jpoint import Curve, Points
from ..fields.constants import LIMB_BITS, NUM_LIMBS

WINDOW_BITS = 8  # default window width of the per-window scan (255 buckets)

SENT = np.uint32(0xFFFFFFFF)


def _roll_fill(P: Points, ident: Points, shift, axis: int, forward: bool):
    """Shift points along `axis` by `shift`, filling vacated slots with
    identity.  forward=True gives P[i - shift] (prefix direction)."""
    n = P.x.shape[axis]
    idx = jnp.arange(n)
    sh = shift if forward else -shift
    rolled = Points(*(jnp.roll(c, sh, axis=axis) for c in P))
    keep1d = (idx >= shift) if forward else (idx < n - shift)
    shape = [1] * P.x.ndim
    shape[axis] = n
    keep = keep1d.reshape(shape)
    return Points(*(jnp.where(keep, r, i) for r, i in zip(rolled, ident)))



def _extract_digits(scalars_std: jnp.ndarray, c: int) -> jnp.ndarray:
    """(W, n) c-bit windows of (n, NUM_LIMBS) standard-form limbs; handles
    windows straddling limb boundaries (any c <= LIMB_BITS)."""
    W = (NUM_LIMBS * LIMB_BITS + c - 1) // c
    cmask = np.uint32((1 << c) - 1)
    out = []
    for w in range(W):
        bit0 = w * c
        limb, off = divmod(bit0, LIMB_BITS)
        d = scalars_std[:, limb] >> off
        if off + c > LIMB_BITS and limb + 1 < NUM_LIMBS:
            d = d | (scalars_std[:, limb + 1] << (LIMB_BITS - off))
        out.append(d & cmask)
    return jnp.stack(out)


def _extract_digits_signed(scalars_std: jnp.ndarray, c: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Signed-digit windows: (W+1, n) magnitudes in [0, 2^(c-1)] plus a
    negation mask, with scalar = sum_w sign_w * mag_w * 2^(c*w).

    Signed digits halve the bucket count (B = 2^(c-1) instead of 2^c - 1):
    a negative digit adds the negated point (free: y -> -y) to bucket
    |digit|.  This buys one extra window bit at the same one-hot select
    cost, cutting the accumulation adds by ~c/(c+1)."""
    d = _extract_digits(scalars_std, c)  # (W, n) in [0, 2^c)
    W, n = d.shape
    half = np.uint32(1 << (c - 1))
    full = np.uint32(1 << c)
    mags, negs = [], []
    carry = jnp.zeros((n,), jnp.uint32)
    for w in range(W):
        v = d[w] + carry
        neg = v > half
        mags.append(jnp.where(neg, full - v, v))
        negs.append(neg)
        carry = jnp.where(neg, jnp.uint32(1), jnp.uint32(0))
    mags.append(carry)  # final carry window, always non-negative
    negs.append(jnp.zeros((n,), bool))
    return jnp.stack(mags), jnp.stack(negs)


def msm(curve: Curve, scalars_std: jnp.ndarray, points: Points, window_bits: int = WINDOW_BITS) -> Points:
    """MSM over fixed-width windows (batched across windows).

    scalars_std: uint32 (n, 16) limbs in *standard* (non-Montgomery) form.
    points: Jacobian batch (n,).  Returns a single Jacobian point (shape ()).
    """
    n = scalars_std.shape[0]
    c = window_bits
    assert LIMB_BITS % c == 0
    W = (NUM_LIMBS * LIMB_BITS) // c
    cmask = np.uint32((1 << c) - 1)
    B = (1 << c) - 1

    # (W, n) digit matrix; dead (zero) digits get the sort-last sentinel
    digits = jnp.stack(
        [
            (scalars_std[:, (w * c) // LIMB_BITS] >> ((w * c) % LIMB_BITS)) & cmask
            for w in range(W)
        ]
    )
    d0 = jnp.where(digits == 0, SENT, digits)
    order = jnp.argsort(d0, axis=1)  # (W, n)
    d = jnp.take_along_axis(d0, order, axis=1)
    P = Points(points.x[order], points.y[order], points.z[order])  # (W, n, L)
    identWn = curve.identity((W, n))
    dead = (d == SENT)[..., None]
    P = Points(*(jnp.where(dead, i, p) for i, p in zip(identWn, P)))

    # --- batched segmented inclusive scan (per window) over axis 1
    steps = max((n - 1).bit_length(), 1)
    row = jnp.arange(n)[None, :]

    def seg_body(j, carry):
        Pc = carry
        shift = jnp.int32(1) << j
        Pprev = _roll_fill(Pc, identWn, shift, axis=1, forward=True)
        d_prev = jnp.roll(d, shift, axis=1)
        same = (row >= shift) & (d_prev == d)
        combined = curve.add(Pc, Pprev)
        return curve.select(same, combined, Pc)

    scanned = jax.lax.fori_loop(0, steps, seg_body, P)

    # --- bucket tails: per-window searchsorted over the sorted digits
    vs = jnp.arange(1, 1 << c, dtype=jnp.uint32)
    idx = jax.vmap(lambda dd: jnp.searchsorted(dd, vs, side="right"))(d) - 1
    idx = jnp.clip(idx, 0, n - 1)  # (W, B)
    tails = Points(
        jnp.take_along_axis(scanned.x, idx[..., None], axis=1),
        jnp.take_along_axis(scanned.y, idx[..., None], axis=1),
        jnp.take_along_axis(scanned.z, idx[..., None], axis=1),
    )
    present = jnp.take_along_axis(d, idx, axis=1) == vs[None, :]
    identWB = curve.identity((W, B))
    buckets = curve.select(present, tails, identWB)

    # --- window totals: sum_v v*B_v = sum of suffix sums; two batched
    # suffix scans, element 0 of the second is the total
    bsteps = max((B - 1).bit_length(), 1)

    def suf_body(j, carry):
        Pc = carry
        shift = jnp.int32(1) << j
        Pnext = _roll_fill(Pc, identWB, shift, axis=1, forward=False)
        return curve.add(Pc, Pnext)

    suffix = jax.lax.fori_loop(0, bsteps, suf_body, buckets)
    total_scan = jax.lax.fori_loop(0, bsteps, suf_body, suffix)
    totals = Points(total_scan.x[:, 0], total_scan.y[:, 0], total_scan.z[:, 0])  # (W,)

    # --- Horner over windows, most significant first
    acc = Points(totals.x[-1], totals.y[-1], totals.z[-1])

    def horner_body(i, acc):
        w = W - 2 - i
        acc = jax.lax.fori_loop(0, c, lambda _, a: curve.dbl(a), acc)
        return curve.add(acc, Points(totals.x[w], totals.y[w], totals.z[w]))

    if W > 1:
        acc = jax.lax.fori_loop(0, W - 1, horner_body, acc)
    return acc


@lru_cache(maxsize=None)
def _msm_jit(curve: Curve, window_bits: int):
    return jax.jit(partial(msm, curve, window_bits=window_bits))


def msm_jitted(curve: Curve, scalars_std, points, window_bits: int = WINDOW_BITS, strategy: str = "scan") -> Points:
    return _msm_jit(curve, window_bits)(scalars_std, points)


# ---------------------------------------------------------------------------
# Sequential-window driver: one jitted window kernel called per window from
# the host (calls pipeline asynchronously on device).  The per-window working
# set is n-wide instead of W*n-wide, and there is exactly ONE kernel compile
# per (n, c).
# ---------------------------------------------------------------------------


def _window_total(curve: Curve, c: int, d0: jnp.ndarray, points: Points) -> Points:
    """Total = sum_v v*B_v for one window; d0 has SENT for dead digits."""
    n = d0.shape[0]
    B = (1 << c) - 1
    order = jnp.argsort(d0)
    d = d0[order]
    P = Points(points.x[order], points.y[order], points.z[order])
    ident = curve.identity((n,))
    dead = (d == SENT)[:, None]
    P = Points(*(jnp.where(dead, i, p) for i, p in zip(ident, P)))

    steps = max((n - 1).bit_length(), 1)
    row = jnp.arange(n)

    def seg_body(j, Pc):
        shift = jnp.int32(1) << j
        Pprev = _roll_fill(Pc, ident, shift, axis=0, forward=True)
        d_prev = jnp.roll(d, shift, axis=0)
        same = (row >= shift) & (d_prev == d)
        return curve.select(same, curve.add(Pc, Pprev), Pc)

    scanned = jax.lax.fori_loop(0, steps, seg_body, P)

    vs = jnp.arange(1, 1 << c, dtype=jnp.uint32)
    idx = jnp.clip(jnp.searchsorted(d, vs, side="right") - 1, 0, n - 1)
    tails = Points(scanned.x[idx], scanned.y[idx], scanned.z[idx])
    present = d[idx] == vs
    identB = curve.identity((B,))
    buckets = curve.select(present, tails, identB)

    bsteps = max((B - 1).bit_length(), 1)

    def suf_body(j, Pc):
        shift = jnp.int32(1) << j
        Pnext = _roll_fill(Pc, identB, shift, axis=0, forward=False)
        return curve.add(Pc, Pnext)

    suffix = jax.lax.fori_loop(0, bsteps, suf_body, buckets)
    total_scan = jax.lax.fori_loop(0, bsteps, suf_body, suffix)
    return Points(total_scan.x[0], total_scan.y[0], total_scan.z[0])


@lru_cache(maxsize=None)
def _window_total_jit(curve: Curve, window_bits: int):
    return jax.jit(partial(_window_total, curve, window_bits))


def msm_host(curve: Curve, scalars_std: jnp.ndarray, points: Points, window_bits: int = WINDOW_BITS):
    """MSM with per-window device kernels + host Horner combine.

    Returns a host gold.AffinePoint (the form every commit consumer wants).
    """
    from ..fields import gold

    c = window_bits
    W = (NUM_LIMBS * LIMB_BITS) // c
    cmask = np.uint32((1 << c) - 1)
    kern = _window_total_jit(curve, c)

    totals_dev = []
    for w in range(W):
        digits = (scalars_std[:, (w * c) // LIMB_BITS] >> ((w * c) % LIMB_BITS)) & cmask
        d0 = jnp.where(digits == 0, SENT, digits)
        totals_dev.append(kern(d0, points))  # async; calls pipeline on device

    stacked = Points(*(jnp.stack([t[i] for t in totals_dev]) for i in range(3)))
    affine = curve.decode(stacked)
    acc = affine[-1]
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = acc.double()
        acc = acc.add(affine[w])
    return acc


# ---------------------------------------------------------------------------
# Bucket-table kernel: classic Pippenger work (n adds per window) as one XLA
# program.  Parallel axes = (window, group); each group serially pushes its elements
# into a private bucket row (conflict-free scatter), then a static halving
# tree merges group tables.  This replaces the Hillis-Steele scan's n*log n
# adds with ~n + G*B adds per window.
# ---------------------------------------------------------------------------


def _bucket_totals(curve: Curve, c: int, G: int, digits: jnp.ndarray, points: Points) -> Points:
    """Per-window totals sum_v v*B_v.

    digits: (W, n) uint32 window digits (0 = dead).
    points: (n,) Jacobian batch.  n must be divisible by G.
    Returns Points with shape (W,).
    """
    W, n = digits.shape
    B = (1 << c) - 1
    g = n // G

    dg = digits.reshape(W, G, g)
    Pg = Points(*(p.reshape(G, g, *p.shape[1:]) for p in points))

    w_ar = jnp.arange(W)[:, None]  # (W, 1)
    g_ar = jnp.arange(G)[None, :]  # (1, G)
    table = curve.identity((W, G, B))

    def body(t, table):
        v = dg[:, :, t]  # (W, G)
        live = v != 0
        vm1 = jnp.where(live, v - 1, 0).astype(jnp.int32)
        cur = Points(*(tc[w_ar, g_ar, vm1] for tc in table))  # (W, G, L)
        e = Points(*(jnp.broadcast_to(pc[:, t][None], cur_c.shape)
                     for pc, cur_c in zip(Pg, cur)))
        new = curve.select(live, curve.add(cur, e), cur)
        return Points(*(
            tc.at[w_ar, g_ar, vm1].set(nc, unique_indices=True)
            for tc, nc in zip(table, new)
        ))

    table = jax.lax.fori_loop(0, g, body, table)

    # static halving tree over the group axis (work-efficient: G*B adds)
    assert G & (G - 1) == 0, "group count must be a power of two"
    while table.x.shape[1] > 1:
        h = table.x.shape[1] // 2
        lo = Points(*(tc[:, :h] for tc in table))
        hi = Points(*(tc[:, h:] for tc in table))
        table = curve.add(lo, hi)
    buckets = Points(*(tc[:, 0] for tc in table))  # (W, B)

    # suffix-of-suffix gives sum_v v*B_v (as in _window_total)
    bsteps = max((B - 1).bit_length(), 1)
    identWB = curve.identity((W, B))

    def suf_body(j, Pc):
        shift = jnp.int32(1) << j
        Pnext = _roll_fill(Pc, identWB, shift, axis=1, forward=False)
        return curve.add(Pc, Pnext)

    suffix = jax.lax.fori_loop(0, bsteps, suf_body, buckets)
    total_scan = jax.lax.fori_loop(0, bsteps, suf_body, suffix)
    return Points(total_scan.x[:, 0], total_scan.y[:, 0], total_scan.z[:, 0])


def _bucket_totals_onehot(curve: Curve, c: int, G: int, mixed: bool,
                          digits: jnp.ndarray, negs: jnp.ndarray | None,
                          points: Points) -> Points:
    """One-hot variant for small windows (c <= 5): the bucket row update is a
    masked select over B buckets instead of an XLA scatter — pure vector ops
    that fuse, trading B*L mask work (cheap) for scatter latency (dominant).

    mixed=True uses the incomplete mixed add for the accumulation step
    (inputs must be distinct non-identity affine points — the commitment-key
    case; see `Curve.add_mixed_fast`).

    negs (same shape as digits) marks signed-digit windows whose point enters
    its bucket negated (B = 2^(c-1) buckets instead of 2^c - 1).
    """
    W, n = digits.shape
    B = (1 << (c - 1)) if negs is not None else (1 << c) - 1
    g = n // G

    dg = digits.reshape(W, G, g)
    Pg = Points(*(p.reshape(G, g, *p.shape[1:]) for p in points))
    neg_y = curve.fb.neg(points.y).reshape(G, g, -1) if negs is not None else None
    ng = negs.reshape(W, G, g) if negs is not None else None
    vs = jnp.arange(1, B + 1, dtype=jnp.uint32)
    table = curve.identity((W, G, B))

    def body(t, table):
        v = dg[:, :, t]  # (W, G)
        oh = v[..., None] == vs  # (W, G, B); all-false for dead v=0
        # masked gather: exactly one bucket matches, so the sum is exact
        cur = Points(*((tc * oh[..., None]).sum(axis=2) for tc in table))
        ex, ey, ez = (jnp.broadcast_to(pc[:, t][None], cur_c.shape)
                      for pc, cur_c in zip(Pg, cur))
        if negs is not None:
            ey = jnp.where(ng[:, :, t][..., None],
                           jnp.broadcast_to(neg_y[:, t][None], ey.shape), ey)
        e = Points(ex, ey, ez)
        new = curve.add_mixed_fast(cur, e) if mixed else curve.add(cur, e)
        return Points(*(
            jnp.where(oh[..., None], nc[:, :, None, :], tc)
            for tc, nc in zip(table, new)
        ))

    table = jax.lax.fori_loop(0, g, body, table)

    assert G & (G - 1) == 0, "group count must be a power of two"
    while table.x.shape[1] > 1:
        h = table.x.shape[1] // 2
        lo = Points(*(tc[:, :h] for tc in table))
        hi = Points(*(tc[:, h:] for tc in table))
        table = curve.add(lo, hi)
    buckets = Points(*(tc[:, 0] for tc in table))  # (W, B)

    bsteps = max((B - 1).bit_length(), 1)
    identWB = curve.identity((W, B))

    def suf_body(j, Pc):
        shift = jnp.int32(1) << j
        Pnext = _roll_fill(Pc, identWB, shift, axis=1, forward=False)
        return curve.add(Pc, Pnext)

    suffix = jax.lax.fori_loop(0, bsteps, suf_body, buckets)
    total_scan = jax.lax.fori_loop(0, bsteps, suf_body, suffix)
    return Points(total_scan.x[:, 0], total_scan.y[:, 0], total_scan.z[:, 0])


@lru_cache(maxsize=None)
def _bucket_totals_jit(curve: Curve, window_bits: int, G: int, mixed: bool = False):
    if window_bits <= 6:
        return jax.jit(partial(_bucket_totals_onehot, curve, window_bits, G, mixed))

    def unsigned(digits, negs, points):
        # negs is None here (an empty pytree under jit): the wide-window
        # scatter path has no signed-digit variant
        return _bucket_totals(curve, window_bits, G, digits, points)

    return jax.jit(unsigned)


def msm_bucket(
    curve: Curve,
    scalars_std: jnp.ndarray,
    points: Points,
    window_bits: int = WINDOW_BITS,
    group_count: int | None = None,
    assume_distinct: bool = False,
    signed_digits: bool = False,
):
    """Bucket-table MSM; returns a host gold.AffinePoint like `msm_host`.

    assume_distinct=True enables the incomplete mixed add for accumulation
    (points must be distinct non-identity affine encodings, z = 1 — true
    for commitment keys; a collision would be a discrete-log relation).
    signed_digits=True uses signed windows (half the buckets per window:
    one extra window bit at the same one-hot cost)."""
    n = scalars_std.shape[0]
    c = window_bits
    G = group_count or (1 << min(7, max(n.bit_length() - 1, 0)))
    if n % G:
        pad = G - n % G
        scalars_std = jnp.concatenate(
            [scalars_std, jnp.zeros((pad, scalars_std.shape[1]), scalars_std.dtype)]
        )
        ident = curve.identity((pad,))
        points = Points(*(jnp.concatenate([pc, ic]) for pc, ic in zip(points, ident)))
        n += pad

    if signed_digits:
        digits, negs = _extract_digits_signed(scalars_std, c)
    else:
        digits, negs = _extract_digits(scalars_std, c), None
    W = digits.shape[0]
    totals = _bucket_totals_jit(curve, c, G, assume_distinct and c <= 6)(
        digits, negs, points
    )

    affine = curve.decode(totals)
    acc = affine[-1]
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = acc.double()
        acc = acc.add(affine[w])
    return acc


def _msm_bucket_fused(curve: Curve, c: int, G: int, mixed: bool,
                      scalars_std: jnp.ndarray, points: Points) -> Points:
    """The whole MSM as ONE traced program: digit extraction, bucket totals,
    and the Horner window combine all on device, so a commit costs one
    dispatch and one transfer instead of one per window."""
    digits = _extract_digits(scalars_std, c)
    W = digits.shape[0]
    if c <= 6:
        totals = _bucket_totals_onehot(curve, c, G, mixed, digits, None, points)
    else:
        totals = _bucket_totals(curve, c, G, digits, points)

    def at(i):
        return Points(*(tc[i] for tc in totals))

    def body(i, acc):
        w = W - 2 - i
        for _ in range(c):
            acc = curve.dbl(acc)
        t = Points(*(
            jax.lax.dynamic_index_in_dim(tc, w, keepdims=False) for tc in totals
        ))
        return curve.add(acc, t)

    out = jax.lax.fori_loop(0, W - 1, body, at(W - 1))
    # leave the device in standard form, stacked: ONE transfer at the call
    # site instead of three from_mont dispatches through curve.decode
    fm = curve.fb.from_mont
    return jnp.stack([fm(out.x), fm(out.y), fm(out.z)])


@lru_cache(maxsize=None)
def _msm_bucket_fused_jit(curve: Curve, c: int, G: int, mixed: bool):
    return jax.jit(partial(_msm_bucket_fused, curve, c, G, mixed))


@lru_cache(maxsize=None)
def _msm_many_fused_jit(curve: Curve, c: int, G: int, mixed: bool):
    """The fused program vmapped over a batch of scalar vectors (shared
    points): its sequential accumulation steps run once for the batch."""
    return jax.jit(jax.vmap(partial(_msm_bucket_fused, curve, c, G, mixed), in_axes=(0, None)))


def _to_affine(curve: Curve, xyz: np.ndarray):
    """(3, L) standard-form Jacobian limbs -> host gold.AffinePoint."""
    from ..fields import gold
    from ..fields.limb import limbs_to_ints

    x, y, z = limbs_to_ints(xyz)
    p = curve.fb.p
    if z % p == 0:
        return gold.identity(curve.spec)
    zi = gold.inv_mod(z % p, p)
    return gold.AffinePoint(curve.spec, x * zi * zi % p, y * zi * zi * zi % p)


def msm_bucket_fused(curve: Curve, scalars_std: jnp.ndarray, points: Points,
                     window_bits: int = 4, group_count: int = 256,
                     assume_distinct: bool = False):
    """Fully-fused bucket MSM; returns a host gold.AffinePoint.  Requires
    n % group_count == 0 (pad at the call site otherwise)."""
    n = scalars_std.shape[0]
    assert n % group_count == 0
    out = _msm_bucket_fused_jit(
        curve, window_bits, group_count, assume_distinct and window_bits <= 6,
    )(scalars_std, points)
    return _to_affine(curve, np.asarray(out))


FUSED_MIN = 4096  # smallest MSM that takes the fused bucket program


def fused_groups(n: int) -> int:
    """Group count of the fused program at n points: n / 256, clamped to
    256..2048.  Every sequential accumulation step (n / groups of them)
    pays a fixed cost for the field ops' inner loops, so fewer, wider steps
    are faster; the (W, groups, 15) bucket table and the merge tree's
    temporaries bound the width."""
    return min(2048, max(256, n >> 8))


def _pad_pow2(curve: Curve, scalars_std: jnp.ndarray, points: Points):
    """Pad the point axis of the scalars (n, L) or (t, n, L) with zeros up
    to a power of two m (all-dead digits, so their points are never added)
    and return m points: the first m of `points` when it holds that many
    (a commitment key), else its first n followed by identities.  Each curve
    then compiles one fused program per power of two, not one per commit
    length (a k=17 primary commit of 7 columns is 917504 points)."""
    n = scalars_std.shape[-2]
    m = 1 << (n - 1).bit_length()
    if m != n:
        pad = [(0, 0)] * (scalars_std.ndim - 2) + [(0, m - n), (0, 0)]
        scalars_std = jnp.pad(scalars_std, pad)
    have = points.x.shape[0]
    if have == m:
        return scalars_std, points
    if have > m:
        return scalars_std, Points(*(pc[:m] for pc in points))
    ident = curve.identity((m - n,))
    return scalars_std, Points(
        *(jnp.concatenate([pc[:n], ic]) for pc, ic in zip(points, ident))
    )


def msm_many(curve: Curve, scalars_std_batch: jnp.ndarray, points: Points,
             assume_distinct: bool = False) -> list:
    """MSMs of t scalar vectors (t, n, L) over the first n of the SHARED
    `points`; a list of host gold.AffinePoints.  n >= FUSED_MIN: one
    batched program (`_msm_many_fused_jit`) and one transfer for all t.
    Smaller: one `best_msm` per vector."""
    t, n = scalars_std_batch.shape[:2]
    if n < FUSED_MIN:
        points = Points(*(pc[:n] for pc in points))
        return [best_msm(curve, scalars_std_batch[i], points, assume_distinct)
                for i in range(t)]
    scalars, points = _pad_pow2(curve, scalars_std_batch, points)
    out = _msm_many_fused_jit(
        curve, 4, fused_groups(scalars.shape[1]), assume_distinct,
    )(scalars, points)  # (t, 3, L)
    return [_to_affine(curve, xyz) for xyz in np.asarray(out)]


def best_msm(curve: Curve, scalars_std: jnp.ndarray, points: Points,
             assume_distinct: bool = False):
    """MSM of n scalars over the first n of `points` (which may be a whole
    commitment key); returns a host gold.AffinePoint.

    n >= FUSED_MIN (every commit of the IVC): the fused one-hot bucket
    program (c = 4, `fused_groups` groups) at n padded to a power of two.
    Smaller inputs: the per-window scan (cheaper compile, adequate at small
    n)."""
    n = scalars_std.shape[0]
    if n >= FUSED_MIN:
        scalars_std, points = _pad_pow2(curve, scalars_std, points)
        return msm_bucket_fused(
            curve, scalars_std, points, window_bits=4,
            group_count=fused_groups(scalars_std.shape[0]),
            assume_distinct=assume_distinct,
        )
    return msm_host(curve, scalars_std, Points(*(pc[:n] for pc in points)), WINDOW_BITS)


_SHARDED_COMPILED: dict = {}


def _sharded_kernel(curve: Curve, c: int, G: int, mixed: bool, mesh):
    """Jitted shard_map bucket kernel, cached per (curve, window, groups,
    add-variant, mesh).  Without this cache every commit re-traced a fresh
    closure — a ~30 s XLA compile per call on an 8-device CPU mesh, which
    both dominated wall time and starved executing device threads into the
    40 s collective-rendezvous timeout."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import ROWS_AXIS

    key = (curve, c, G, mixed, mesh)
    fn = _SHARDED_COMPILED.get(key)
    if fn is not None:
        return fn

    def per_device(dg, px, py, pz):
        totals = (
            _bucket_totals_onehot(curve, c, G, mixed, dg, None, Points(px, py, pz))
            if c <= 5
            else _bucket_totals(curve, c, G, dg, Points(px, py, pz))
        )
        # (W, L) per device -> stack under a leading device-local axis of 1
        return totals.x[None], totals.y[None], totals.z[None]

    fn = jax.jit(
        shard_map(
            per_device,
            mesh=mesh,
            in_specs=(P(None, ROWS_AXIS), P(ROWS_AXIS), P(ROWS_AXIS), P(ROWS_AXIS)),
            out_specs=(P(ROWS_AXIS), P(ROWS_AXIS), P(ROWS_AXIS)),
            # loop carries start as unsharded constants (bucket tables of
            # identities); skip the varying-manual-axes check
            check_vma=False,
        )
    )
    _SHARDED_COMPILED[key] = fn
    return fn


def msm_sharded(
    curve: Curve,
    scalars_std: jnp.ndarray,
    points: Points,
    mesh,
    window_bits: int = 4,
    group_count: int = 64,
    assume_distinct: bool = False,
):
    """Multi-chip MSM: shard points/scalars row-wise over a 1-D mesh; every
    device runs the bucket-table kernel on its shard (embarrassingly
    parallel), producing per-device window totals; the D*W tiny Jacobian
    totals are combined on the host (EC addition is not a psum-able monoid,
    and D*W points are negligible next to the sharded accumulation).

    Returns a host gold.AffinePoint.
    """
    from ..fields import gold
    from ..parallel.mesh import shard_rows

    n = scalars_std.shape[0]
    c = window_bits
    D = mesh.devices.size
    G = group_count
    chunk = G * ((n + D * G - 1) // (D * G))  # per-device size, multiple of G
    pad = D * chunk - n
    if pad:
        scalars_std = jnp.concatenate(
            [scalars_std, jnp.zeros((pad, scalars_std.shape[1]), scalars_std.dtype)]
        )
        ident = curve.identity((pad,))
        points = Points(*(jnp.concatenate([pc, ic]) for pc, ic in zip(points, ident)))

    digits = _extract_digits(scalars_std, c)  # (W, D*chunk)
    W = digits.shape[0]
    digits = shard_rows(mesh, digits, axis=1)
    points = Points(*(shard_rows(mesh, pc, axis=0) for pc in points))

    mixed = assume_distinct and c <= 5
    kern = _sharded_kernel(curve, c, G, mixed, mesh)
    tx, ty, tz = kern(digits, points.x, points.y, points.z)
    # (D, W) Jacobian totals -> host combine
    per_dev = curve.decode(Points(tx.reshape(-1, tx.shape[-1]),
                                  ty.reshape(-1, ty.shape[-1]),
                                  tz.reshape(-1, tz.shape[-1])))
    totals = []
    for w in range(W):
        acc = per_dev[w]
        for d in range(1, D):
            acc = acc.add(per_dev[d * W + w])
        totals.append(acc)
    acc = totals[-1]
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = acc.double()
        acc = acc.add(totals[w])
    return acc


def msm_naive(curve: Curve, scalars_std: jnp.ndarray, points: Points) -> Points:
    """Binary double-and-add reference kernel (for tests / tiny inputs)."""
    nbits = 16 * NUM_LIMBS

    def body(i, acc):
        b = nbits - 1 - i
        acc = curve.dbl(acc)
        bit = (scalars_std[:, b // LIMB_BITS] >> (b % LIMB_BITS)) & 1
        masked = curve.select(bit > 0, points, curve.identity(points.shape))
        return curve.add(acc, curve.sum_reduce(masked, axis=0))

    return jax.lax.fori_loop(0, nbits, body, curve.identity(()))
