"""Limb-FIRST field arithmetic: arrays are uint32[L, ...rows] (limbs on
axis 0), the transpose of `jfield.Field`'s uint32[..., L].

Why: the LAST axis of an array is its contiguous one.  The limb-last layout
puts the 16 limbs there, so a thread that handles one row strides through
memory and neighbouring threads read addresses 64 bytes apart; limb-first
puts the rows there, so neighbouring threads read neighbouring words
(coalesced access) while keeping the exact same vectorized CIOS structure
and op count (compile size stays small, unlike a per-limb list
representation).

Used by the compiled hot programs (gate-leaf sweeps, tree reductions,
folds): they transpose (n, L) <-> (L, n) once at the program boundary —
one cheap pass — and run every field op limb-first in between.

Semantics mirror `jfield.Field` exactly; see its docstrings.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .constants import LIMB_BITS, LIMB_MASK, NUM_LIMBS, FieldSpec
from . import limb as limbutil
from .jfield import Field

L = NUM_LIMBS
MASK = np.uint32(LIMB_MASK)


def to_lf(a: jnp.ndarray) -> jnp.ndarray:
    """(..., L) -> (L, ...)."""
    return jnp.moveaxis(a, -1, 0)


def from_lf(a: jnp.ndarray) -> jnp.ndarray:
    """(L, ...) -> (..., L)."""
    return jnp.moveaxis(a, 0, -1)


def _pad_first(x, before: int, after: int):
    pads = [(before, after)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pads)


class FieldLF:
    """Limb-first twin of `jfield.Field` (same spec-derived constants)."""

    def __init__(self, base: Field):
        self.base = base
        self.spec = base.spec
        self.p = base.p
        self.n0inv = base.n0inv
        # keep constants as NUMPY: a jnp constant created while tracing (the
        # lru_cache means __init__ can run inside a jit) leaks a tracer
        self._p_col = np.asarray(base.p_limbs)
        self._notp_col = np.asarray(base.not_p_limbs)
        self._one_col = np.asarray(base.one_mont_limbs)

    def __hash__(self):
        return hash(("lf", self.spec.name))

    def __eq__(self, other):
        return isinstance(other, FieldLF) and self.spec.name == other.spec.name

    def _bcast_const(self, col, ndim):
        return col.reshape((L,) + (1,) * (ndim - 1))

    @staticmethod
    def _align(a, b):
        """Row-shape broadcasting (numpy-style, aligned from the right) with
        the limb axis pinned at 0: (L,) x (L, n) -> (L, 1) x (L, n)."""
        nd = max(a.ndim, b.ndim)
        if a.ndim < nd:
            a = a.reshape((L,) + (1,) * (nd - a.ndim) + a.shape[1:])
        if b.ndim < nd:
            b = b.reshape((L,) + (1,) * (nd - b.ndim) + b.shape[1:])
        return a, b

    def zeros(self, shape=()) -> jnp.ndarray:
        return jnp.zeros((L,) + tuple(shape), jnp.uint32)

    def ones(self, shape=()) -> jnp.ndarray:
        return jnp.broadcast_to(
            self._one_col.reshape((L,) + (1,) * len(tuple(shape))), (L,) + tuple(shape)
        )

    def encode(self, xs) -> jnp.ndarray:
        return to_lf(self.base.encode(xs))

    def const(self, x: int, shape=()) -> jnp.ndarray:
        """Constant int -> (L,) + shape Montgomery array."""
        lim = limbutil.int_to_limbs((x % self.p) * (1 << 256) % self.p)
        return jnp.broadcast_to(
            jnp.asarray(lim).reshape((L,) + (1,) * len(tuple(shape))),
            (L,) + tuple(shape),
        )

    # -- carry machinery -------------------------------------------------------
    @staticmethod
    def _ripple(t):
        """Carry-propagate along the limb axis, a scan as in `Field._ripple`:
        unrolled, every add's chain of steps is inlined into the program,
        and the NTT and fold programs compile several times slower
        (PERF.md)."""

        def step(c, tj):
            s = tj + c
            return s >> LIMB_BITS, s & MASK

        c, outs = jax.lax.scan(step, jnp.zeros(t.shape[1:], jnp.uint32), t)
        return outs, c

    def _cond_sub_p(self, r):
        t = r + self._bcast_const(self._notp_col, r.ndim)
        t = t.at[0].add(1)
        d, co = self._ripple(t)
        return jnp.where(co > 0, d, r)

    # -- ring ops --------------------------------------------------------------
    def add(self, a, b):
        a, b = self._align(a, b)
        r, _ = self._ripple(a + b)
        return self._cond_sub_p(r)

    def sub(self, a, b):
        a, b = self._align(a, b)
        t = a + (b ^ MASK)
        t = t.at[0].add(1)
        d, co = self._ripple(t)
        d2, _ = self._ripple(d + self._bcast_const(self._p_col, d.ndim))
        return jnp.where(co > 0, d, d2)

    def neg(self, a):
        return self.sub(jnp.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        """Montgomery CIOS, limbs on axis 0 (rows contiguous).  Same lazy-carry
        structure and op count as `Field.mul`."""
        a, b = self._align(a, b)
        shape = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
        a = jnp.broadcast_to(a, (L,) + shape)
        b = jnp.broadcast_to(b, (L,) + shape)
        p_col = self._bcast_const(self._p_col, 1 + len(shape))

        def step(t, ai):
            prod = ai[None] * b
            t = t + _pad_first(prod & MASK, 0, 1) + _pad_first(prod >> LIMB_BITS, 1, 0)
            m = ((t[0] & MASK) * self.n0inv) & MASK
            q = m[None] * p_col
            t = t + _pad_first(q & MASK, 0, 1) + _pad_first(q >> LIMB_BITS, 1, 0)
            carry0 = t[0] >> LIMB_BITS
            return jnp.concatenate(
                [
                    (t[1:2] + carry0[None]),
                    t[2:],
                    jnp.zeros((1,) + shape, jnp.uint32),
                ]
            )

        t = jnp.zeros((L + 1,) + shape, jnp.uint32)
        t = jax.lax.fori_loop(
            0, L, lambda i, t: step(t, jax.lax.dynamic_index_in_dim(a, i, keepdims=False)), t
        )
        r, _ = self._ripple(t)
        return self._cond_sub_p(r[:L])

    def square(self, a):
        return self.mul(a, a)

    def from_mont(self, a):
        one = jnp.zeros((L,) + (1,) * (a.ndim - 1), jnp.uint32).at[0].set(1)
        return self.mul(a, one)

    # -- predicates ------------------------------------------------------------
    def is_zero(self, a):
        return jnp.all(a == 0, axis=0)

    def eq(self, a, b):
        return jnp.all(a == b, axis=0)

    def select(self, cond, x, y):
        """cond: bool (...rows); x, y: (L, ...rows)."""
        return jnp.where(cond[None], x, y)

    def sum_reduce(self, a, axis: int = 0):
        """Log-depth modular sum along row-`axis` (axis counted in row dims,
        i.e. array axis = axis + 1)."""
        ax = axis + 1
        a = jnp.moveaxis(a, ax, 1)
        n = a.shape[1]
        while n > 1:
            half = n // 2
            lo, hi = a[:, :half], a[:, half : 2 * half]
            s = self.add(lo, hi)
            if n % 2:
                s = jnp.concatenate([s, a[:, 2 * half : n]], axis=1)
            a = s
            n = a.shape[1]
        return a[:, 0]


@lru_cache(maxsize=None)
def lf_for(field: Field) -> FieldLF:
    return FieldLF(field)
