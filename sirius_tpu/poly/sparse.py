"""Sparse matrices (COO) for permutation checks.

Replaces reference `src/polynomial/sparse.rs` (SURVEY.md §2.1).  The host
form is a triplet list; the device form turns P @ Z into gather + weighted
segment-sum, which XLA lowers to device scatter/gather.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..fields.jfield import Field
from ..fields.limb import int_to_limbs as limbutil_int_to_limbs

# host: list of (row, col, value_int)
SparseMatrix = list  # list[tuple[int, int, int]]


def matrix_multiply(m: Sequence[tuple[int, int, int]], z: Sequence[int], p: int, num_rows: int | None = None) -> list[int]:
    """Gold model: out[row] += value * z[col] (reference `sparse.rs:5-19`)."""
    n = num_rows if num_rows is not None else (max(r for r, _, _ in m) + 1 if m else 0)
    out = [0] * n
    for r, c, v in m:
        out[r] = (out[r] + v * z[c]) % p
    return out


class DeviceSparse:
    """Device COO matrix with precomputed index/value arrays."""

    def __init__(self, field: Field, triplets: Sequence[tuple[int, int, int]], num_rows: int):
        self.f = field
        self.num_rows = num_rows
        if triplets:
            rows, cols, vals = zip(*triplets)
        else:
            rows, cols, vals = (), (), ()
        self.rows = jnp.asarray(np.asarray(rows, dtype=np.int32))
        self.cols = jnp.asarray(np.asarray(cols, dtype=np.int32))
        self.vals = field.encode(list(vals))
        self.matvec = jax.jit(self.matvec)

    def matvec(self, z: jnp.ndarray) -> jnp.ndarray:
        """(P @ z) for Montgomery z (m, L) -> Montgomery (num_rows, L).

        Limb-wise scatter-add into a 17-limb accumulator (up to 2^16 terms of
        < 2^255 each fit), then fold the 272-bit totals back mod p.
        """
        f = self.f
        L = z.shape[-1]
        contrib = f.mul(self.vals, z[self.cols])  # (nnz, L) mont(v*z)
        acc = jnp.zeros((self.num_rows, L + 1), jnp.uint32)
        acc = acc.at[self.rows].add(jnp.pad(contrib, ((0, 0), (0, 1))))
        limbs, _ = f._ripple(acc)
        lo, hi = limbs[..., :L], limbs[..., L]
        r2 = jnp.asarray(f.r2_limbs)
        # The summed integer S = lo + hi*2^256 satisfies S ≡ mont(P@z) mod p;
        # reduce each part mod p in plain (non-Montgomery-scaling) fashion:
        #   lo mod p       = mont_mul(mont_mul(lo, R2), 1)
        #   hi*2^256 mod p = mont_mul(mont_mul(hi, R2), (2^256 mod p))
        lo_mod = f.from_mont(f.mul(lo, r2))
        hi_fe = jnp.zeros((self.num_rows, L), jnp.uint32).at[..., 0].set(hi)
        shift_plain = jnp.asarray(limbutil_int_to_limbs((1 << 256) % f.p))
        hi_mod = f.mul(f.mul(hi_fe, r2), shift_plain)
        return f.add(lo_mod, hi_mod)
