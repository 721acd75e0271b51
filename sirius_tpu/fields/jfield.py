"""JAX limbed Montgomery field arithmetic — the device compute foundation.

Device replacement for the reference's Rust `halo2curves` field arithmetic
(reference `src/lib.rs:24-27` re-exports; SURVEY.md §2.8 item 1).

Representation
--------------
A field element batch is a `uint32[..., 16]` array of little-endian 16-bit
limbs.  Canonical form: every limb < 2^16 and the value < p.  Arithmetic is in
the Montgomery domain with R = 2^256: `mont(x) = x * R mod p`.

Why 16x16: a limb product fits uint32 exactly ((2^16-1)^2 < 2^32) and the
CIOS inner loop's lazy-carry accumulators stay < 2^22 << 2^32, so the whole
multiplier runs as elementwise uint32 array ops with no per-step carry
ripple.  A single carry ripple at the end canonicalizes.

All functions are pure, shape-polymorphic over leading axes, and jit/vmap
friendly.  Constants are closed over as numpy arrays (baked into the jaxpr).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .constants import LIMB_BITS, LIMB_MASK, NUM_LIMBS, FieldSpec
from . import limb as limbutil

L = NUM_LIMBS
MASK = np.uint32(LIMB_MASK)

def _pad_last(x, before: int, after: int):
    pads = [(0, 0)] * (x.ndim - 1) + [(before, after)]
    return jnp.pad(x, pads)


class Field:
    """Per-prime device arithmetic context.

    Instances are lightweight and hashable by field name so they can be used
    as static arguments to jitted functions.
    """

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.p = spec.modulus
        self.p_limbs = limbutil.int_to_limbs(spec.modulus)
        self.not_p_limbs = (self.p_limbs ^ np.uint32(LIMB_MASK)).astype(np.uint32)
        self.n0inv = np.uint32(spec.n0_inv)
        self.r_mod_p = spec.r_mod_p
        self.one_mont_limbs = limbutil.int_to_limbs(spec.r_mod_p)
        self.r2_limbs = limbutil.int_to_limbs(spec.r2_mod_p)
        self.zero_limbs = np.zeros(L, dtype=np.uint32)
        # jit-wrap hot ops so eager/test usage hits the compile cache instead
        # of dispatching hundreds of primitive ops per call
        self.add = jax.jit(self.add)
        self.sub = jax.jit(self.sub)
        self.neg = jax.jit(self.neg)
        self.mul = jax.jit(self.mul)
        self.square = jax.jit(self.square)
        self.to_mont = jax.jit(self.to_mont)
        self.to_mont_words = jax.jit(self.to_mont_words)
        self.from_mont = jax.jit(self.from_mont)
        self.inv = jax.jit(self.inv)
        self.batch_inv = jax.jit(self.batch_inv, static_argnames=("axis",))
        self.sum_reduce = jax.jit(self.sum_reduce, static_argnames=("axis",))

    # -- identity / hashing for jit static args --------------------------------
    def __hash__(self):
        return hash(self.spec.name)

    def __eq__(self, other):
        return isinstance(other, Field) and self.spec.name == other.spec.name

    def __repr__(self):
        return f"Field({self.spec.name})"

    # -- host conversions ------------------------------------------------------
    def encode(self, xs: Sequence[int] | int) -> jnp.ndarray:
        """Host ints -> device array in Montgomery form."""
        if isinstance(xs, int):
            return jnp.asarray(limbutil.int_to_limbs(xs * (1 << 256) % self.p))
        arr = limbutil.ints_to_limbs([x * (1 << 256) % self.p for x in xs])
        return jnp.asarray(arr)

    def decode(self, arr) -> list[int]:
        """Device Montgomery array (..., L) -> list of ints (C-order)."""
        std = self.from_mont(jnp.asarray(arr))
        return [v % self.p for v in limbutil.limbs_to_ints(np.asarray(std))]

    def decode_one(self, arr) -> int:
        arr = jnp.asarray(arr)
        if arr.ndim == 1:
            arr = arr[None]
        return self.decode(arr)[0]

    # -- shape helpers ---------------------------------------------------------
    def zeros(self, shape=()) -> jnp.ndarray:
        return jnp.zeros(tuple(shape) + (L,), jnp.uint32)

    def ones(self, shape=()) -> jnp.ndarray:
        return jnp.broadcast_to(jnp.asarray(self.one_mont_limbs), tuple(shape) + (L,))

    def const(self, x: int, shape=()) -> jnp.ndarray:
        """Constant int -> broadcasted Montgomery array."""
        lim = limbutil.int_to_limbs((x % self.p) * (1 << 256) % self.p)
        return jnp.broadcast_to(jnp.asarray(lim), tuple(shape) + (L,))

    # -- carry machinery -------------------------------------------------------
    @staticmethod
    def _ripple(t):
        """Carry-propagate (..., n) uint32 accumulators (< 2^31 each) into
        canonical 16-bit limbs.  Returns (limbs, carry_out)."""
        tt = jnp.moveaxis(t, -1, 0)

        def step(c, tj):
            s = tj + c
            return s >> LIMB_BITS, s & MASK

        c, outs = jax.lax.scan(step, jnp.zeros(t.shape[:-1], jnp.uint32), tt)
        return jnp.moveaxis(outs, 0, -1), c

    def _cond_sub_p(self, r):
        """r (..., L) canonical limbs with value < 2p -> value mod p."""
        t = r + jnp.asarray(self.not_p_limbs)
        t = t.at[..., 0].add(1)
        d, co = self._ripple(t)
        ge = (co > 0)[..., None]
        return jnp.where(ge, d, r)

    # -- ring ops (Montgomery domain in == Montgomery domain out) --------------
    def add(self, a, b):
        t = a + b  # limbs < 2^17
        r, _ = self._ripple(t)
        return self._cond_sub_p(r)

    def sub(self, a, b):
        # a - b via complement: a + (2^256 - b); carry-out == 1 iff a >= b
        t = a + (b ^ MASK)
        t = t.at[..., 0].add(1)
        d, co = self._ripple(t)
        # if a < b, add p back
        d2, _ = self._ripple(d + jnp.asarray(self.p_limbs))
        return jnp.where((co > 0)[..., None], d, d2)

    def neg(self, a):
        return self.sub(jnp.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        """Montgomery product: returns a*b*R^{-1} mod p.  CIOS with lazy carries.

        The 16 CIOS iterations are a fori_loop, not unrolled: unrolled, the
        programs that hold many multiplies grow ~20x and take minutes to
        compile on the GPU (measured: PERF.md).
        """
        shape = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        a = jnp.broadcast_to(a, shape + (L,))
        b = jnp.broadcast_to(b, shape + (L,))
        p_limbs = jnp.asarray(self.p_limbs)

        def step(t, ai):
            prod = ai[..., None] * b  # exact uint32
            t = t + _pad_last(prod & MASK, 0, 1) + _pad_last(prod >> LIMB_BITS, 1, 0)
            m = ((t[..., 0] & MASK) * self.n0inv) & MASK
            q = m[..., None] * p_limbs
            t = t + _pad_last(q & MASK, 0, 1) + _pad_last(q >> LIMB_BITS, 1, 0)
            carry0 = t[..., 0] >> LIMB_BITS  # t[...,0] == 0 mod 2^16 by construction
            return jnp.concatenate(
                [(t[..., 1:2] + carry0[..., None]), t[..., 2:], jnp.zeros(shape + (1,), jnp.uint32)],
                axis=-1,
            )

        t = jnp.zeros(shape + (L + 1,), jnp.uint32)
        t = jax.lax.fori_loop(
            0, L, lambda i, t: step(t, jax.lax.dynamic_index_in_dim(a, i, axis=-1, keepdims=False)), t
        )
        r, _ = self._ripple(t)
        return self._cond_sub_p(r[..., :L])

    def square(self, a):
        return self.mul(a, a)

    # -- Montgomery domain conversion ------------------------------------------
    def to_mont(self, a_std):
        return self.mul(a_std, jnp.asarray(self.r2_limbs))

    def to_mont_words(self, words):
        """(..., 8) uint32 little-endian 32-bit words (standard form, packed
        32 bytes/element — half the host-to-device transfer of (..., 16)
        uint32 limbs) -> Montgomery (..., L)."""
        w = jnp.asarray(words)
        limbs = jnp.stack([w & MASK, w >> LIMB_BITS], axis=-1).reshape(
            w.shape[:-1] + (L,)
        )
        return self.to_mont(limbs)

    def from_mont(self, a_mont):
        one = jnp.zeros(L, jnp.uint32).at[0].set(1)
        return self.mul(a_mont, one)

    # -- predicates -------------------------------------------------------------
    def is_zero(self, a):
        return jnp.all(a == 0, axis=-1)

    def eq(self, a, b):
        return jnp.all(a == b, axis=-1)

    def select(self, cond, x, y):
        """cond: bool (...) ; x, y: (..., L)."""
        return jnp.where(cond[..., None], x, y)

    # -- exponentiation / inversion ---------------------------------------------
    def pow_bits(self, a, e_bits):
        """a^e where e_bits is a device uint32 (nbits,) little-endian bit array."""
        nbits = e_bits.shape[0]

        def body(i, carry):
            acc, base = carry
            bit = e_bits[i]
            acc = self.select(bit > 0, self.mul(acc, base), acc)
            base = self.square(base)
            return acc, base

        acc0 = self.ones(a.shape[:-1])
        acc, _ = jax.lax.fori_loop(0, nbits, body, (acc0, a))
        return acc

    def pow_int(self, a, e: int):
        """a^e for a host-known exponent (jit-compatible: bits are baked)."""
        assert e >= 0
        nbits = max(e.bit_length(), 1)
        bits = np.array([(e >> i) & 1 for i in range(nbits)], dtype=np.uint32)
        return self.pow_bits(a, jnp.asarray(bits))

    def inv(self, a):
        """Fermat inverse a^(p-2); inv(0) = 0."""
        return self.pow_int(a, self.p - 2)

    def batch_inv(self, a, axis: int = 0):
        """Montgomery batch inversion along `axis`; zeros map to zeros
        (reference `src/util/mod.rs:128-153` semantics)."""
        a = jnp.moveaxis(a, axis, 0)
        nz = ~self.is_zero(a)
        one = self.ones(a.shape[:-1])
        a1 = self.select(nz, a, one)
        prefix = jax.lax.associative_scan(self.mul, a1, axis=0)
        suffix = jax.lax.associative_scan(self.mul, a1, axis=0, reverse=True)
        total_inv = self.inv(prefix[-1])
        # a_i^{-1} = P_{i-1} * S_{i+1} * total^{-1}
        p_prev = jnp.concatenate([one[:1], prefix[:-1]], axis=0)
        s_next = jnp.concatenate([suffix[1:], one[:1]], axis=0)
        out = self.mul(self.mul(p_prev, s_next), total_inv)
        out = self.select(nz, out, jnp.zeros_like(out))
        return jnp.moveaxis(out, 0, axis)

    def sum_reduce(self, a, axis: int = 0):
        """Log-depth modular sum along `axis` (exact, canonical output)."""
        a = jnp.moveaxis(a, axis, 0)
        n = a.shape[0]
        while n > 1:
            half = n // 2
            lo, hi = a[:half], a[half : 2 * half]
            s = self.add(lo, hi)
            if n % 2:
                s = jnp.concatenate([s, a[2 * half : n]], axis=0)
            a = s
            n = a.shape[0]
        return a[0]

    # -- misc -------------------------------------------------------------------
    def random(self, shape, rng: np.random.Generator | None = None) -> jnp.ndarray:
        rng = rng or np.random.default_rng()
        total = int(np.prod(shape)) if shape else 1
        vals = [int(rng.integers(0, 2**63)) | (int(rng.integers(0, 2**63)) << 63) | (int(rng.integers(0, 2**63)) << 126) | (int(rng.integers(0, 2**63)) << 189) for _ in range(total)]
        vals = [v % self.p for v in vals]
        out = self.encode(vals)
        return out.reshape(tuple(shape) + (L,))


# Singletons ---------------------------------------------------------------
from .constants import bn256_fq, bn256_fr, pasta_fp, pasta_fq  # noqa: E402

FQ = Field(bn256_fq)
FR = Field(bn256_fr)
PASTA_FP = Field(pasta_fp)
PASTA_FQ = Field(pasta_fq)

_FIELDS = {f.spec.name: f for f in (FQ, FR, PASTA_FP, PASTA_FQ)}


def field_for(spec: FieldSpec) -> Field:
    return _FIELDS[spec.name]
