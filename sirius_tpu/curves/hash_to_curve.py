"""Deterministic hash-to-curve (Shallue–van de Woestijne, RFC 9380 §6.6.1).

Used by commitment-key setup (reference `src/commitment.rs:55-79` feeds
Shake256 XOF output through halo2curves' `hash_to_curve`).  We implement the
standard SVDW map with Z chosen per curve; the derivation is self-consistent
and deterministic but not byte-identical to halo2curves' pipeline (which is
pinned to a specific halo2 fork rev); see PARITY.md.
"""

from __future__ import annotations

from functools import lru_cache

from ..fields.constants import CurveSpec
from ..fields.gold import AffinePoint, identity
from ..fields.constants import FieldSpec


def _is_square(a: int, p: int) -> bool:
    return a % p == 0 or pow(a, (p - 1) // 2, p) == 1


def _sqrt(a: int, p: int) -> int:
    from .hash_to_curve import _tonelli  # self

    return _tonelli(a % p, p)


def _tonelli(a: int, p: int) -> int:
    if a == 0:
        return 0
    assert _is_square(a, p)
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    s, q = 0, p - 1
    while q % 2 == 0:
        s += 1
        q //= 2
    z = 2
    while _is_square(z, p):
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2i = 0, t
        while t2i != 1:
            t2i = t2i * t2i % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


@lru_cache(maxsize=None)
def _svdw_constants(curve: CurveSpec) -> tuple[int, int, int, int, int]:
    """(Z, c1, c2, c3, c4) per RFC 9380 §6.6.1."""
    p = curve.base.modulus
    A, B = curve.a, curve.b

    def g(x):
        return (pow(x, 3, p) + A * x + B) % p

    # smallest Z by the RFC's criteria, searched as 1, -1, 2, -2, ...
    candidates = []
    for mag in range(1, 50):
        candidates += [mag, p - mag]
    for Z in candidates:
        gz = g(Z)
        denom = (3 * Z * Z + 4 * A) % p
        if gz == 0 or denom == 0:
            continue
        # -(3Z^2+4A)/(4g(Z)) must be a nonzero square <=> -(3Z^2+4A)*g(Z) square
        c3_sq = (-gz % p) * denom % p
        if not _is_square(c3_sq, p):
            continue
        # at least one of g(Z), g(-Z/2) must be square
        if not (_is_square(gz, p) or _is_square(g((-Z * pow(2, -1, p)) % p), p)):
            continue
        c1 = gz
        c2 = (-Z * pow(2, -1, p)) % p
        c3 = _tonelli(c3_sq, p)
        if c3 % 2 == 1:  # sgn0(c3) must be 0
            c3 = p - c3
        c4 = (-4 * gz % p) * pow(denom, -1, p) % p
        return Z, c1, c2, c3, c4
    raise ValueError(f"no SVDW Z found for {curve.name}")


def svdw_map(curve: CurveSpec, u: int) -> AffinePoint:
    """RFC 9380 map_to_curve_svdw."""
    p = curve.base.modulus
    A, B = curve.a, curve.b
    Z, c1, c2, c3, c4 = _svdw_constants(curve)

    def inv0(x):
        return pow(x, -1, p) if x % p else 0

    u %= p
    tv1 = u * u % p * c1 % p
    tv2 = (1 + tv1) % p
    tv1 = (1 - tv1) % p
    tv3 = inv0(tv1 * tv2 % p)
    tv4 = u * tv1 % p * tv3 % p * c3 % p
    x1 = (c2 - tv4) % p
    gx1 = (pow(x1, 3, p) + A * x1 + B) % p
    x2 = (c2 + tv4) % p
    gx2 = (pow(x2, 3, p) + A * x2 + B) % p
    x3 = (pow(tv2, 2, p) * tv3 % p) ** 2 % p * c4 % p + Z
    x3 %= p
    if _is_square(gx1, p):
        x, gx = x1, gx1
    elif _is_square(gx2, p):
        x, gx = x2, gx2
    else:
        x = x3
        gx = (pow(x, 3, p) + A * x + B) % p
    y = _tonelli(gx, p)
    if (u % 2) != (y % 2):  # sgn0 match
        y = p - y
    return AffinePoint(curve, x, y)


def hash_bytes_to_point(curve: CurveSpec, uniform: bytes) -> AffinePoint:
    """64 uniform bytes -> point: two field elements -> SVDW -> sum
    (standard hash_to_curve composition for uniform encodings)."""
    assert len(uniform) == 64
    p = curve.base.modulus
    u0 = int.from_bytes(uniform[:32], "little") % p
    u1 = int.from_bytes(uniform[32:], "little") % p
    return svdw_map(curve, u0).add(svdw_map(curve, u1))


# ---------------------------------------------------------------------------
# Device-batched SVDW (bit-identical to the host map above) — key setup for
# 2^20+ generators runs as a few hundred batched field ops instead of
# millions of host modpows.  Program-size discipline (compile time grows
# with program size): pow-chain inversions instead of
# associative-scan batch_inv (each scan stage is a distinct fused kernel),
# ONE stacked sqrt over all three SVDW x-candidates instead of two Legendre
# towers + a sqrt, and both halves of the 64-byte input mapped in one call.
# p = 3 (mod 4) uses sqrt = a^((p+1)/4); p = 1 (mod 4) (grumpkin's base
# field = bn256 Fr, 2-adicity 28) uses a constant-iteration Tonelli–Shanks.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _ts_constants(p: int) -> tuple[int, int, int]:
    """(S, Q, z) with p-1 = Q·2^S, Q odd, z the smallest quadratic
    non-residue — the classic Tonelli–Shanks parameters."""
    S, Q = 0, p - 1
    while Q % 2 == 0:
        S += 1
        Q //= 2
    z = 2
    while _is_square(z, p):
        z += 1
    return S, Q, z


def _sqrt_device(f, a):
    """Batched deterministic sqrt *attempt*: returns y with y*y == a iff a is
    a quadratic residue (callers test y^2 == a instead of running a separate
    Legendre tower; for non-residues y is an unspecified field element).
    Matches host `_tonelli` up to sign — SVDW's sgn0 parity fix makes the
    final y bit-identical either way."""
    import jax

    p = f.p
    if p % 4 == 3:
        return f.pow_int(a, (p + 1) // 4)
    # constant-iteration Tonelli–Shanks (p = 1 mod 4)
    S, Q, z = _ts_constants(p)
    shape = a.shape[:-1]
    one = f.ones(shape)
    c = f.const(pow(z, Q, p), shape)  # generator of the 2-Sylow subgroup
    t = f.pow_int(a, Q)
    R = f.pow_int(a, (Q + 1) // 2)
    for i in range(S - 1, 0, -1):
        # b = t^(2^(i-1)) is ±1 when a is a QR (inductively ord(t) | 2^i)
        if i - 1 > 0:
            b = jax.lax.fori_loop(0, i - 1, lambda _, v: f.square(v), t)
        else:
            b = t
        flag = ~f.eq(b, one)  # b == -1: fold c into the root
        R = f.select(flag, f.mul(R, c), R)
        c = f.square(c)
        t = f.select(flag, f.mul(t, c), t)
    return R


def svdw_map_device(jcurve, u_std):
    """Batched RFC 9380 map_to_curve_svdw.

    jcurve: curves.jpoint.Curve; u_std: (n, L) standard-form limbs of ANY
    256-bit value (reduction mod p happens in the Montgomery lift, matching
    the host map's `u %= p`).  Returns device Points with z = 1 (Montgomery).
    """
    import jax.numpy as jnp

    from .jpoint import Points

    spec = jcurve.spec
    f = jcurve.fb
    p = f.p
    assert spec.a == 0
    Z, c1, c2, c3, c4 = _svdw_constants(spec)

    n = u_std.shape[0]
    u = f.to_mont(u_std)  # mont(u mod p)

    def g(x):
        return f.add(f.mul(f.square(x), x), f.const(spec.b, x.shape[:-1]))

    one = f.ones((n,))
    tv1 = f.mul(f.square(u), f.const(c1, (n,)))
    tv2 = f.add(one, tv1)
    tv1 = f.sub(one, tv1)
    prod = f.mul(tv1, tv2)
    tv3 = f.pow_int(prod, p - 2)  # inv0 (0 -> 0), one pow chain
    tv4 = f.mul(f.mul(f.mul(u, tv1), tv3), f.const(c3, (n,)))
    x1 = f.sub(f.const(c2, (n,)), tv4)
    x2 = f.add(f.const(c2, (n,)), tv4)
    x3 = f.add(
        f.mul(f.square(f.mul(f.square(tv2), tv3)), f.const(c4, (n,))),
        f.const(Z, (n,)),
    )

    # one sqrt program over all three candidates; y_i^2 == g(x_i) doubles as
    # the quadratic-residue test (SVDW guarantees at least one x_i works)
    xs = jnp.concatenate([x1, x2, x3], axis=0)
    gxs = g(xs)
    ys = _sqrt_device(f, gxs)
    is_sq = f.eq(f.square(ys), gxs)
    sq1, sq2 = is_sq[:n] | f.is_zero(gxs[:n]), is_sq[n : 2 * n] | f.is_zero(
        gxs[n : 2 * n]
    )
    x = f.select(sq1, x1, f.select(sq2, x2, x3))
    y = f.select(sq1, ys[:n], f.select(sq2, ys[n : 2 * n], ys[2 * n :]))
    # zero-residue candidates: y from the sqrt attempt may be garbage for
    # gx == 0 under Tonelli–Shanks; force y = 0 to match the host map
    y = f.select(f.is_zero(g(x)), f.zeros((n,)), y)

    # sgn0 tie-break: parity of y must equal parity of (u mod p)
    y_std = f.from_mont(y)
    u_red = f.from_mont(u)
    flip = (y_std[..., 0] & 1) != (u_red[..., 0] & 1)
    y = f.select(flip, f.neg(y), y)
    return Points(x, y, f.ones((n,)))


_HB2P_COMPILED: dict = {}


def hash_bytes_to_points_device(jcurve, uniform: bytes):
    """Batched hash_bytes_to_point: len(uniform) = 64*n bytes -> n affine
    device Points (z = 1 Montgomery), bit-identical to the host map.

    The jitted program is cached per (curve, n): key setup slices the XOF
    stream into fixed-size chunks, so one compile serves every chunk (a
    fresh `jax.jit` per chunk would compile once per chunk).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .jpoint import Points

    f = jcurve.fb
    n = len(uniform) // 64
    # (n, 64) bytes -> two (n, 16) uint16-limb arrays (little-endian halves)
    raw = np.frombuffer(uniform, dtype=np.uint16).reshape(n, 32)
    u0 = jnp.asarray(raw[:, :16].astype(np.uint32))
    u1 = jnp.asarray(raw[:, 16:].astype(np.uint32))

    key = (jcurve.spec.name, n)
    fn = _HB2P_COMPILED.get(key)
    if fn is None:

        def run(u0, u1):
            # one stacked map call for both halves (one sqrt program, not two)
            P = svdw_map_device(jcurve, jnp.concatenate([u0, u1], axis=0))
            P0 = Points(P.x[:n], P.y[:n], P.z[:n])
            P1 = Points(P.x[n:], P.y[n:], P.z[n:])
            S = jcurve.add(P0, P1)
            # normalize to z = 1: (x/z^2, y/z^3); pow-chain inverse keeps the
            # program free of associative-scan stages (compile size)
            zinv = f.pow_int(S.z, f.p - 2)
            zi2 = f.square(zinv)
            return Points(f.mul(S.x, zi2), f.mul(S.y, f.mul(zi2, zinv)), f.ones((n,)))

        fn = jax.jit(run)
        _HB2P_COMPILED[key] = fn
    return fn(u0, u1)
