"""JAX elliptic-curve point kernels (Jacobian coordinates, a = 0 curves).

Device replacement for the reference's `halo2curves` group arithmetic
(SURVEY.md §2.8 item 1/2).  A point batch is a `Points` pytree of three
`uint32[..., 16]` Montgomery-limb arrays; infinity is encoded as z == 0.

Branchless: exceptional cases (identity operands, doubling, inverse pair) are
resolved with vectorized selects so the same program runs for every lane —
the XLA-friendly analogue of halo2curves' conditional logic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import gold
from ..fields.constants import NUM_LIMBS, CurveSpec
from ..fields.jfield import Field, field_for


class Points(NamedTuple):
    """Batch of Jacobian points over some base field; z == 0 <=> identity."""

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    @property
    def shape(self):
        return self.x.shape[:-1]


class Curve:
    """Device curve context: base-field ops + curve constants."""

    def __init__(self, spec: CurveSpec):
        self.spec = spec
        self.fb: Field = field_for(spec.base)
        self.fs: Field = field_for(spec.scalar)
        assert spec.a == 0, "only a=0 short Weierstrass curves supported"
        self.b_mont = np.asarray(self.fb.encode([spec.b]))[0]
        # jit hot ops
        self.add = jax.jit(self.add)
        self.dbl = jax.jit(self.dbl)

    def __hash__(self):
        return hash(self.spec.name)

    def __eq__(self, other):
        return isinstance(other, Curve) and self.spec.name == other.spec.name

    def __repr__(self):
        return f"Curve({self.spec.name})"

    # -- constructors ----------------------------------------------------------
    def identity(self, shape=()) -> Points:
        f = self.fb
        return Points(f.zeros(shape), f.ones(shape), f.zeros(shape))

    def encode(self, pts: Sequence[gold.AffinePoint]) -> Points:
        """Host gold affine points -> device Jacobian batch."""
        f = self.fb
        xs = [0 if p.is_identity else p.x for p in pts]
        ys = [1 if p.is_identity else p.y for p in pts]
        zs = [0 if p.is_identity else 1 for p in pts]
        return Points(f.encode(xs), f.encode(ys), f.encode(zs))

    def decode(self, P: Points) -> list[gold.AffinePoint]:
        """Device batch -> host gold affine points."""
        f = self.fb
        xs = f.decode(P.x.reshape(-1, NUM_LIMBS))
        ys = f.decode(P.y.reshape(-1, NUM_LIMBS))
        zs = f.decode(P.z.reshape(-1, NUM_LIMBS))
        out = []
        for x, y, z in zip(xs, ys, zs):
            if z == 0:
                out.append(gold.identity(self.spec))
            else:
                zi = gold.inv_mod(z, f.p)
                out.append(
                    gold.AffinePoint(self.spec, x * zi * zi % f.p, y * zi * zi * zi % f.p)
                )
        return out

    # -- predicates ------------------------------------------------------------
    def is_identity(self, P: Points):
        return self.fb.is_zero(P.z)

    def select(self, cond, P: Points, Q: Points) -> Points:
        f = self.fb
        return Points(f.select(cond, P.x, Q.x), f.select(cond, P.y, Q.y), f.select(cond, P.z, Q.z))

    def neg(self, P: Points) -> Points:
        return Points(P.x, self.fb.neg(P.y), P.z)

    # -- group law -------------------------------------------------------------
    # Independent field muls are stacked into single batched calls: fewer,
    # wider kernels (one mont-mul program instance per group instead of one
    # per operand) — smaller programs to compile, fewer kernels to launch.
    def dbl(self, P: Points) -> Points:
        """Jacobian doubling, a=0 (dbl-2009-l).  Identity-safe (z3 = 2*y*z)."""
        f = self.fb
        A, B = f.square(jnp.stack([P.x, P.y]))
        C, T = f.square(jnp.stack([B, f.add(P.x, B)]))
        D = f.double(f.sub(f.sub(T, A), C))
        E = f.add(f.double(A), A)
        F = f.square(E)
        X3 = f.sub(F, f.double(D))
        u, v = f.mul(jnp.stack([E, P.y]), jnp.stack([f.sub(D, X3), P.z]))
        Y3 = f.sub(u, f.double(f.double(f.double(C))))
        Z3 = f.double(v)
        return Points(X3, Y3, Z3)

    def add(self, P: Points, Q: Points) -> Points:
        """Complete Jacobian addition via select over the exceptional cases."""
        f = self.fb
        z1z1, z2z2 = f.square(jnp.stack([P.z, Q.z]))
        u1, u2, t1, t2 = f.mul(
            jnp.stack([P.x, Q.x, P.y, Q.y]), jnp.stack([z2z2, z1z1, Q.z, P.z])
        )
        s1, s2 = f.mul(jnp.stack([t1, t2]), jnp.stack([z2z2, z1z1]))
        h = f.sub(u2, u1)
        r = f.sub(s2, s1)
        hh, r2 = f.square(jnp.stack([h, r]))
        hhh, v, zz = f.mul(jnp.stack([h, u1, P.z]), jnp.stack([hh, hh, Q.z]))
        x3 = f.sub(f.sub(r2, hhh), f.double(v))
        a, b, z3 = f.mul(jnp.stack([r, s1, zz]), jnp.stack([f.sub(v, x3), hhh, h]))
        y3 = f.sub(a, b)
        general = Points(x3, y3, z3)

        p_inf = self.is_identity(P)
        q_inf = self.is_identity(Q)
        h_zero = f.is_zero(h)
        r_zero = f.is_zero(r)
        # same x: doubling if same y, else infinity
        dbl_case = h_zero & r_zero & ~p_inf & ~q_inf
        inf_case = h_zero & ~r_zero & ~p_inf & ~q_inf

        out = self.select(dbl_case, self.dbl(P), general)
        out = self.select(inf_case, self.identity(out.shape), out)
        out = self.select(q_inf, P, out)
        out = self.select(p_inf, Q, out)
        return out

    def add_mixed_fast(self, P: Points, Q: Points) -> Points:
        """Incomplete mixed addition (madd-2007-bl, 7M+4S): Q MUST be affine
        (z = 1 in Montgomery form) and not the identity, and Q != +-P must
        hold for non-identity P.  P may be the identity (z = 0).

        For MSM bucket accumulation over distinct generator points, where a
        bucket value colliding with an incoming point would constitute a
        discrete-log relation between key generators (the standard Pippenger
        incompleteness argument; the complete `add` remains the default for
        general inputs).
        """
        f = self.fb
        z1z1 = f.square(P.z)
        u2, t = f.mul(jnp.stack([Q.x, Q.y]), jnp.stack([z1z1, P.z]))
        s2 = f.mul(t, z1z1)
        h = f.sub(u2, P.x)
        rr = f.double(f.sub(s2, P.y))
        hh, r2, zh2 = f.square(jnp.stack([h, rr, f.add(P.z, h)]))
        i4 = f.double(f.double(hh))
        j, v = f.mul(jnp.stack([h, P.x]), jnp.stack([i4, i4]))
        x3 = f.sub(f.sub(r2, j), f.double(v))
        a, b = f.mul(jnp.stack([rr, P.y]), jnp.stack([f.sub(v, x3), j]))
        y3 = f.sub(a, f.double(b))
        z3 = f.sub(f.sub(zh2, z1z1), hh)
        out = Points(x3, y3, z3)
        return self.select(self.is_identity(P), Q, out)

    # -- helpers ----------------------------------------------------------------
    def scalar_mul(self, P: Points, k_bits: jnp.ndarray) -> Points:
        """Double-and-add; k_bits uint32 (nbits,) little-endian. For tests."""
        nbits = k_bits.shape[0]

        def body(i, carry):
            acc, base = carry
            acc2 = self.add(acc, base)
            acc = self.select(k_bits[i] > 0, acc2, acc)
            base = self.dbl(base)
            return acc, base

        acc0 = self.identity(P.shape)
        acc, _ = jax.lax.fori_loop(0, nbits, body, (acc0, P))
        return acc

    def sum_reduce(self, P: Points, axis: int = 0) -> Points:
        """Log-depth point summation along `axis`."""
        P = Points(*(jnp.moveaxis(c, axis, 0) for c in P))
        n = P.shape[0]
        while n > 1:
            half = n // 2
            lo = Points(P.x[:half], P.y[:half], P.z[:half])
            hi = Points(P.x[half : 2 * half], P.y[half : 2 * half], P.z[half : 2 * half])
            s = self.add(lo, hi)
            if n % 2:
                s = Points(*(jnp.concatenate([c, cr[2 * half : n]], axis=0) for c, cr in zip(s, P)))
            P = s
            n = P.shape[0]
        return Points(P.x[0], P.y[0], P.z[0])


from ..fields.constants import bn256_g1, grumpkin, pallas, vesta  # noqa: E402

BN256_G1 = Curve(bn256_g1)
GRUMPKIN = Curve(grumpkin)
PALLAS = Curve(pallas)
VESTA = Curve(vesta)

_CURVES = {c.spec.name: c for c in (BN256_G1, GRUMPKIN, PALLAS, VESTA)}


def curve_for(spec: CurveSpec) -> Curve:
    return _CURVES[spec.name]
