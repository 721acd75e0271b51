"""Pedersen vector commitments over a fixed generator key.

Replaces reference `src/commitment.rs` (SURVEY.md §2.1): `setup` derives 2^k
generators from a Shake256 XOF over the label -> hash-to-curve; `commit` is
an MSM over the first len(v) generators.  Keys cache to disk keyed by
(label, k) like the reference's `.cache` flow (`commitment.rs:99-170`).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

_RLC_COMPILED: dict = {}

from ..curves import jpoint
from ..curves.hash_to_curve import hash_bytes_to_point
from ..curves.jpoint import Curve, Points
from ..fields import gold
from ..fields.constants import NUM_LIMBS, CurveSpec
from ..fields.limb import ints_to_limbs
from ..ops import msm as msm_ops
from ..util.cache import DATA_DIR as CACHE_DIR


def _pack_words(limbs: np.ndarray) -> np.ndarray:
    """(n, 16) uint32 16-bit limbs -> (n, 8) uint32 32-bit words."""
    lo = limbs[:, 0::2].astype(np.uint32)
    hi = limbs[:, 1::2].astype(np.uint32)
    return lo | (hi << 16)


@lru_cache(maxsize=None)
def _unpack_words_jit(n: int):
    """(n, 8) words -> (n, 16) limbs on device (one tiny cached program)."""
    import jax

    def run(xw, yw):
        def unpack(w):
            lo = w & jnp.uint32(0xFFFF)
            hi = w >> 16
            return jnp.stack([lo, hi], axis=-1).reshape(w.shape[0], 16)

        return unpack(xw), unpack(yw)

    return jax.jit(run)


class CommitmentError(Exception):
    pass


class TooLongInput(CommitmentError):
    def __init__(self, input_len, limit):
        super().__init__(f"input len {input_len} > key size {limit}")


@dataclass
class CommitmentKey:
    """2^k generators, resident on device as a Jacobian batch (z=1)."""

    curve: Curve
    points: Points  # (n,) device batch
    label: bytes
    k: int
    window_bits: int = 16

    def __len__(self):
        return self.points.x.shape[0]

    @staticmethod
    def setup(curve: Curve, k: int, label: bytes, use_cache: bool = True, window_bits: int = 16) -> "CommitmentKey":
        """Shake256(label) XOF -> 64 uniform bytes/point -> SVDW hash-to-curve
        (reference `commitment.rs:55-79` structure)."""
        n = 1 << k
        cache_file = os.path.join(
            CACHE_DIR, f"{curve.spec.name}-{label.decode(errors='ignore')}-{k}.npz"
        )
        if use_cache and os.path.exists(cache_file):
            data = np.load(cache_file)
            if "xw" in data:
                # packed format: (n, 8) uint32 words per Montgomery coord,
                # z = 1 implied — 1/3 the bytes of (n, 16)x3 limb arrays to
                # load and transfer for 2^20+ keys
                xw, yw = jnp.asarray(data["xw"]), jnp.asarray(data["yw"])
                ux, uy = _unpack_words_jit(xw.shape[0])(xw, yw)
                f = curve.fb
                pts = Points(ux, uy, f.ones((xw.shape[0],)))
            else:  # legacy limb-array caches
                pts = Points(
                    jnp.asarray(data["x"]), jnp.asarray(data["y"]), jnp.asarray(data["z"])
                )
            return CommitmentKey(curve, pts, label, k, window_bits)

        xof = hashlib.shake_256(label)
        stream = xof.digest(64 * n)
        if n >= 4096:
            # device-batched SVDW (bit-identical to the host map; both
            # p mod 4 cases — constant-iteration Tonelli–Shanks for p = 1);
            # chunked to bound peak memory at reference-scale keys (2^23+)
            from ..curves.hash_to_curve import hash_bytes_to_points_device

            # fixed chunk size: every key size shares ONE compiled SVDW
            # program, whose compile time grows with its width
            chunk = min(n, 1 << 16)
            parts = [
                hash_bytes_to_points_device(curve, stream[i * 64 : (i + chunk) * 64])
                for i in range(0, n, chunk)
            ]
            pts = Points(*(jnp.concatenate([getattr(pp, c) for pp in parts]) for c in ("x", "y", "z")))
        else:
            affine = [
                hash_bytes_to_point(curve.spec, stream[i * 64 : (i + 1) * 64]) for i in range(n)
            ]
            pts = curve.encode(affine)
        if use_cache:
            os.makedirs(CACHE_DIR, exist_ok=True)
            np.savez(
                cache_file,
                xw=_pack_words(np.asarray(pts.x)),
                yw=_pack_words(np.asarray(pts.y)),
            )
        return CommitmentKey(curve, pts, label, k, window_bits)

    def commit_device(self, w_mont: jnp.ndarray, window_bits: int | None = None) -> gold.AffinePoint:
        """Commit to a (size, L) Montgomery device array.  Under an active
        mesh (`parallel.context`), points/scalars shard row-wise and every
        device runs the bucket kernel on its slice."""
        scalars = self.curve.fs.from_mont(w_mont)
        n = scalars.shape[0]
        if n > len(self):
            raise TooLongInput(n, len(self))
        if n == 0:
            return gold.identity(self.curve.spec)
        from ..parallel.context import get_mesh

        mesh = get_mesh()
        sharded = mesh is not None and mesh.devices.size > 1
        if window_bits is None and not sharded:
            # key generators are distinct SVDW outputs -> mixed-add fast path;
            # the whole key goes in, so a padded commit reuses its points
            return msm_ops.best_msm(self.curve, scalars, self.points, assume_distinct=True)
        pts = Points(self.points.x[:n], self.points.y[:n], self.points.z[:n])
        if sharded:
            return msm_ops.msm_sharded(
                self.curve, scalars, pts, mesh, assume_distinct=True
            )
        res = msm_ops.msm_jitted(self.curve, scalars, pts, window_bits=window_bits)
        return self.curve.decode(Points(*(c[None] for c in res)))[0]

    def commit_device_many(self, w_monts: jnp.ndarray) -> list:
        """Commit to a (t, size, L) batch of Montgomery device arrays (shared
        key points)."""
        scalars = self.curve.fs.from_mont(w_monts)
        t, n = scalars.shape[:2]
        if n > len(self):
            raise TooLongInput(n, len(self))
        return msm_ops.msm_many(self.curve, scalars, self.points, assume_distinct=True)

    def batched_commit_check(self, pairs) -> list[int]:
        """Probabilistic batch verification of commitment openings.

        pairs = [(W_dev (size, L) Montgomery, C gold.AffinePoint), ...].
        Checks commit(W_i) == C_i for ALL i with ONE MSM: draw Fiat-Shamir
        rho_i from a Poseidon transcript over the claimed commitments, verify
        commit(sum_i rho_i W_i) == sum_i rho_i C_i.  Sound up to 2^-128 per
        the standard random-linear-combination argument (the reference
        re-commits each witness separately, `plonk/mod.rs:336-344` — the RLC
        check is ~k-fold cheaper for k openings and is the verifier's own
        coin, so no protocol change).  Returns failing indices ([] = all
        pass); on mismatch falls back to per-pair checks to localize."""
        from ..fields.jfield import field_for
        from ..ops.poseidon import PoseidonHash, poseidon_spec
        from ..util.ro import NUM_CHALLENGE_BITS

        pairs = list(pairs)
        if not pairs:
            return []
        if len(pairs) == 1:
            W, C = pairs[0]
            return [] if self.commit_device(W) == C else [0]
        fs = field_for(self.curve.fs.spec)
        ro = PoseidonHash(poseidon_spec(self.curve.spec.scalar, 3, 2, 4, 3))
        for _, C in pairs:
            x, y = (0, 0) if C.is_identity else (C.x, C.y)
            ro.absorb_field(x % fs.p)
            ro.absorb_field(y % fs.p)
        rhos = []
        for _ in pairs:
            rhos.append(ro.squeeze(NUM_CHALLENGE_BITS) % fs.p)

        sizes = tuple(int(W.shape[0]) for W, _ in pairs)
        max_n = max(sizes)
        key = ("rlc", fs.spec.name, sizes)
        fn = _RLC_COMPILED.get(key)
        if fn is None:

            def run(ws, rho_dev):
                acc = None
                for i, w in enumerate(ws):
                    term = fs.mul(w, rho_dev[i])
                    if w.shape[0] < max_n:
                        term = jnp.concatenate(
                            [term, fs.zeros((max_n - w.shape[0],))]
                        )
                    acc = term if acc is None else fs.add(acc, term)
                return acc

            fn = jax.jit(run)
            _RLC_COMPILED[key] = fn
        rho_dev = fs.encode(rhos)
        combined = fn([W for W, _ in pairs], rho_dev)
        expected = gold.identity(self.curve.spec)
        for rho, (_, C) in zip(rhos, pairs):
            expected = expected.add(C.mul(rho))
        if self.commit_device(combined) == expected:
            return []
        return [i for i, (W, C) in enumerate(pairs) if self.commit_device(W) != C]

    def commit(self, v_ints: list[int] | jnp.ndarray, window_bits: int | None = None) -> gold.AffinePoint:
        """Commit to a scalar vector (host ints or (n,16) standard-form limb
        array); returns the affine point (reference `commitment.rs:81-90`).

        Backend selected by SIRIUS_TPU_COMMIT_BACKEND: "device" (default,
        XLA bucket MSM) or "native" (C++ multi-threaded Pippenger, the host
        analogue of the reference's rayon best_multiexp)."""
        if isinstance(v_ints, (list, tuple)):
            n = len(v_ints)
            ints = [v % self.curve.fs.p for v in v_ints]
            scalars = None
        else:
            scalars = v_ints
            n = scalars.shape[0]
            ints = None
        if n > len(self):
            raise TooLongInput(n, len(self))
        if os.environ.get("SIRIUS_TPU_COMMIT_BACKEND", "device") == "native":
            from .. import native

            if native.available():
                if ints is None:
                    from ..fields.limb import limbs_to_ints

                    ints = limbs_to_ints(np.asarray(scalars))
                return native.native_msm(self.curve.spec, self.host_points()[:n], ints)
        if scalars is None:
            scalars = jnp.asarray(ints_to_limbs(ints))
        if window_bits is None and self.window_bits == 16:
            # default keys: same best-kernel dispatch as commit_device
            # (explicit small windows — CPU tests — keep the cheap-compile
            # scan kernel)
            return msm_ops.best_msm(self.curve, scalars, self.points, assume_distinct=True)
        pts = Points(self.points.x[:n], self.points.y[:n], self.points.z[:n])
        res = msm_ops.msm_jitted(self.curve, scalars, pts, window_bits=window_bits or self.window_bits)
        return self.curve.decode(Points(*(c[None] for c in res)))[0]

    def host_points(self) -> list[gold.AffinePoint]:
        """Decoded affine generators (cached; used by the native backend)."""
        cached = getattr(self, "_host_points", None)
        if cached is None:
            cached = self.curve.decode(self.points)
            self._host_points = cached
        return cached
