"""Radix-2 NTT over limbed prime fields (device, limb-first).

Device replacement for reference `src/fft.rs` (SURVEY.md §2.1).  The
recursive rayon strategy becomes an iterative vectorized butterfly ladder:
each of the k stages is one batched Montgomery multiply + add/sub over the
whole (row-shardable) domain, compiled into a single XLA program.

Layout: the ladder runs LIMB-FIRST (uint32[L, n], rows on the minor axis)
— the same layout as every other hot op here: limb-last puts the 16 limbs
on the minor axis, limb-first puts the 2^k rows there, so neighbouring
threads read neighbouring rows (coalesced access).  The public API stays limb-last (n, L) at the boundary with one
transpose pass each way; `fft_lf` exposes the native limb-first entry.

Stage scheduling details:
- the m==1 stage multiplies by omega^0 == 1, so it is a pure add/sub (no
  Montgomery mul) — k stages cost (k-1) * n/2 muls total;
- twiddles for every stage are precomputed host-side into one table per
  direction and sliced statically, so the compiled program has no gathers
  beyond the initial bit-reverse permutation;
- the inverse scaling by 1/2^k fuses into the final stage's twiddle table
  (t = hi * (w/n), lo' = lo/n) — saving a full-domain mul pass.

Semantics (bit-exact targets, verified against the gold model and the
reference's inline vector `src/fft.rs:241-252`):
- omega = ROOT_OF_UNITY^(2^(S-k)) (`fft.rs:12-23`)
- ifft scales by 1/2^k (`fft.rs:25-27,168-182`)
- coset fft/ifft distribute zeta^(i mod 3) powers (`fft.rs:186-228`)
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import gold
from ..fields.constants import NUM_LIMBS, FieldSpec
from ..fields.jfield import Field, field_for
from ..fields.jfield_lf import lf_for, to_lf, from_lf

L = NUM_LIMBS


def _bit_reverse_indices(k: int) -> np.ndarray:
    n = 1 << k
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int32)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


class NTT:
    """Per-(field, k) NTT context with precomputed twiddle tables."""

    def __init__(self, field: Field, k: int):
        assert k <= field.spec.two_adicity
        self.f = field
        self.lf = lf_for(field)
        self.k = k
        self.n = 1 << k
        p = field.p
        omega = gold.omega_for_k(field.spec, k)
        omega_inv = pow(omega, -1, p)
        n_inv = pow(self.n, -1, p)

        def powers_lf(base: int, count: int, scale: int = 1) -> np.ndarray:
            vals, acc = [], scale % p
            for _ in range(count):
                vals.append(acc)
                acc = acc * base % p
            return np.asarray(field.encode(vals)).T.copy()  # (L, count)

        half = max(self.n // 2, 1)
        self.w_table = powers_lf(omega, half)  # (L, half): omega^j, j < n/2
        self.w_inv_table = powers_lf(omega_inv, half)
        # last-stage inverse twiddles pre-scaled by 1/n (fuses the ifft scale)
        self.w_inv_scaled = powers_lf(omega_inv, half, scale=n_inv)
        self.rev_idx = _bit_reverse_indices(k)
        self.n_inv_col = np.asarray(field.encode([n_inv])).T.copy()  # (L, 1)
        zeta = field.spec.zeta
        # zeta^(i mod 3) and inverse patterns over the domain (limb-first)
        zpow = [pow(zeta, i % 3, p) for i in range(self.n)]
        zpow_inv = [pow(zeta, (-(i % 3)) % 3, p) for i in range(self.n)]
        self.zeta_pows = np.asarray(field.encode(zpow)).T.copy()
        self.zeta_inv_pows = np.asarray(field.encode(zpow_inv)).T.copy()

        # four-step decomposition (k >= 10): n = n1*n2, two column-NTT
        # passes over a long minor axis; SIRIUS_TPU_NTT_LADDER=1 forces the
        # flat ladder (oracle / microbenchmarks)
        import os as _os

        self.use_four_step = k >= 10 and _os.environ.get("SIRIUS_TPU_NTT_LADDER") != "1"
        if self.use_four_step:
            self.n1 = 1 << ((k + 1) // 2)
            self.n2 = 1 << (k // 2)
            w_in = pow(omega, self.n2, p)  # order n1
            w_out = pow(omega, self.n1, p)  # order n2
            self.w_inner = powers_lf(w_in, max(self.n1 // 2, 1))
            self.w_inner_inv = powers_lf(pow(w_in, -1, p), max(self.n1 // 2, 1))
            self.w_outer = powers_lf(w_out, max(self.n2 // 2, 1))
            self.w_outer_inv = powers_lf(pow(w_out, -1, p), max(self.n2 // 2, 1))
            self.w_base = powers_lf(omega, self.n2)  # (L, n2): w^i2
            self.w_base_inv = powers_lf(omega_inv, self.n2)
            self.rev_n1 = _bit_reverse_indices((k + 1) // 2)
            self.rev_n2 = _bit_reverse_indices(k // 2)
        self._mid_cache: dict = {}

        self._fft_lf_jit = jax.jit(self._fft_lf_core, static_argnames=("inverse",))
        self._four_jit = jax.jit(self._four_step_core, static_argnames=("inverse",))
        self.coset_fft = self._coset_fft
        self.coset_ifft = self._coset_ifft

    # -- limb-first core -------------------------------------------------------
    def _ladder(self, al: jnp.ndarray, inverse: bool) -> jnp.ndarray:
        """al: (L, n) bit-reversed input -> (L, n) natural-order output."""
        lf, n = self.lf, self.n
        table = jnp.asarray(self.w_inv_table if inverse else self.w_table)
        last = jnp.asarray(self.w_inv_scaled) if inverse else table
        m = 1
        while m < n:
            nb = n // (2 * m)
            view = al.reshape(L, nb, 2, m)
            lo, hi = view[:, :, 0], view[:, :, 1]
            if m == 1 and n > 2:
                # twiddle == omega^0 == 1: butterfly without the mul
                t = hi
            else:
                tab = last if 2 * m == n else table
                w = tab[:, :: nb][:, :m]  # (L, m)
                t = lf.mul(hi, w[:, None, :])
                if 2 * m == n and inverse:
                    # fold the 1/n scale into lo as well
                    lo = lf.mul(lo, jnp.asarray(self.n_inv_col)[:, None, :])
            al = jnp.stack([lf.add(lo, t), lf.sub(lo, t)], axis=2).reshape(L, n)
            m *= 2
        if inverse and n <= 2:
            al = lf.mul(al, jnp.asarray(self.n_inv_col))
        return al

    # -- four-step (Bailey) core ----------------------------------------------
    # The flat ladder's stage at half-size m has its butterfly pairs on a
    # minor axis of extent m, so its early stages work on short contiguous
    # runs.  The n = n1*n2 decomposition runs two column-NTT passes whose
    # butterflies always keep a large axis minor (long contiguous runs every
    # stage), one (L, n) transpose between them, and a fused mid-twiddle:
    #   X[o2*n1 + o1] = sum_i2 w^(n1*i2*o2) * [ T[o1,i2] *
    #                       sum_i1 x[i1*n2 + i2] * w^(n2*i1*o1) ]
    #   with T[o1,i2] = w^(o1*i2)  (times 1/n for the inverse transform).

    def _col_ntt(self, a: jnp.ndarray, size: int, rev: np.ndarray, table: jnp.ndarray) -> jnp.ndarray:
        """NTT along axis 1 of (L, size, R); R is the contiguous minor axis."""
        lf = self.lf
        R = a.shape[2]
        a = a[:, jnp.asarray(rev), :]
        m = 1
        while m < size:
            nb = size // (2 * m)
            view = a.reshape(L, nb, 2, m, R)
            lo, hi = view[:, :, 0], view[:, :, 1]
            if m == 1 and size > 2:
                t = hi
            else:
                w = table[:, ::nb][:, :m]
                t = lf.mul(hi, w[:, None, :, None])
            a = jnp.stack([lf.add(lo, t), lf.sub(lo, t)], axis=2).reshape(L, size, R)
            m *= 2
        return a

    def _four_step_core(self, al: jnp.ndarray, mid: jnp.ndarray, inverse: bool) -> jnp.ndarray:
        n1, n2 = self.n1, self.n2
        inner = jnp.asarray(self.w_inner_inv if inverse else self.w_inner)
        outer = jnp.asarray(self.w_outer_inv if inverse else self.w_outer)
        M = al.reshape(L, n1, n2)
        A = self._col_ntt(M, n1, self.rev_n1, inner)  # (L, o1, i2)
        B = self.lf.mul(A, mid)
        D = jnp.swapaxes(B, 1, 2)  # (L, i2, o1)
        E = self._col_ntt(D, n2, self.rev_n2, outer)  # (L, o2, o1)
        return E.reshape(L, self.n)

    def _mid_twiddle(self, inverse: bool) -> jnp.ndarray:
        """T[o1, i2] = w^(+-o1*i2) (times 1/n when inverse), built EAGERLY
        on device once per direction: n1 chained (L, n2) Montgomery muls."""
        cached = self._mid_cache.get(inverse)
        if cached is not None:
            return cached
        base = jnp.asarray(self.w_base_inv if inverse else self.w_base)  # (L, n2): w^(+-i2)
        start = (
            jnp.broadcast_to(jnp.asarray(self.n_inv_col), (L, self.n2))
            if inverse
            else self.lf.ones((self.n2,))
        )
        lf = self.lf

        def step(row, _):
            return lf.mul(row, base), row

        _, rows = jax.jit(lambda s: jax.lax.scan(step, s, None, length=self.n1))(start)
        T = jnp.moveaxis(rows, 0, 1)  # (L, n1, n2)
        T.block_until_ready()
        self._mid_cache[inverse] = T
        return T

    def _fft_lf_core(self, al: jnp.ndarray, inverse: bool = False) -> jnp.ndarray:
        return self._ladder(al[:, jnp.asarray(self.rev_idx)], inverse)

    def fft_lf(self, al: jnp.ndarray, inverse: bool = False) -> jnp.ndarray:
        """al: (L, n) standard or Montgomery form (linear map either way)."""
        assert al.shape == (L, self.n)
        if self.use_four_step:
            return self._four_jit(al, self._mid_twiddle(inverse), inverse)
        return self._fft_lf_jit(al, inverse)

    # -- limb-last public API --------------------------------------------------
    def fft(self, a: jnp.ndarray, inverse: bool = False) -> jnp.ndarray:
        """a: (n, L) standard or Montgomery form (linear map either way)."""
        assert a.shape[0] == self.n
        return from_lf(self.fft_lf(to_lf(a), inverse))

    # alias kept for callers that took the bound jit directly
    _fft = fft

    def ifft(self, a):
        return self.fft(a, inverse=True)

    def ifft_lf(self, al):
        return self.fft_lf(al, inverse=True)

    def _coset_fft(self, a):
        al = self.lf.mul(to_lf(a), jnp.asarray(self.zeta_pows))
        return from_lf(self.fft_lf(al, inverse=False))

    def _coset_ifft(self, a):
        al = self.fft_lf(to_lf(a), inverse=True)
        return from_lf(self.lf.mul(al, jnp.asarray(self.zeta_inv_pows)))


@lru_cache(maxsize=None)
def ntt_ctx(spec: FieldSpec, k: int) -> NTT:
    return NTT(field_for(spec), k)
