"""The commit MSM path the GPU takes: `best_msm` -> the fused one-hot bucket
program (c = 4, 256 groups) at n = 4096, on both curves of the cycle; a
commit whose length is not a power of two (padded with key points or with
identities); the batched `msm_many`; and the smoke test's MSM check."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from sirius_tpu.curves.jpoint import BN256_G1, GRUMPKIN, Points
from sirius_tpu.fields import gold
from sirius_tpu.ops.commitment import CommitmentKey
from sirius_tpu.ops.msm import best_msm, msm_many

LOG_N = 12
N = 1 << LOG_N
KEY_LOG = LOG_N + 1  # room for a commit of N + 256 points padded with key points


def _key(curve, seed):
    """A key of 2^KEY_LOG distinct affine points P_i = e_i * G, e_i = r0 + i*r.

    Known discrete logs make the gold reference one scalar multiplication:
    sum_i s_i P_i = (sum_i s_i e_i) G.  Random r0, r keep every bucket sum
    off the incoming point, as the mixed add requires."""
    spec = curve.spec
    q = spec.scalar.modulus
    rnd = random.Random(seed)
    r0, r = rnd.randrange(1, q), rnd.randrange(1, q)
    g = gold.AffinePoint(spec, spec.gx, spec.gy)
    step = g.mul(r)
    size = 1 << KEY_LOG
    pts = [g.mul(r0)]
    for _ in range(size - 1):
        pts.append(pts[-1].add(step))
    exps = [(r0 + i * r) % q for i in range(size)]
    return CommitmentKey(curve, curve.encode(pts), b"test-commit-msm", KEY_LOG), exps, g


@pytest.fixture(scope="module")
def keys():
    return {c.spec.name: _key(c, seed) for seed, c in enumerate((BN256_G1, GRUMPKIN))}


@pytest.mark.parametrize("curve", [BN256_G1, GRUMPKIN], ids=lambda c: c.spec.name)
def test_best_msm_matches_gold(curve, keys):
    ck, exps, g = keys[curve.spec.name]
    q = curve.spec.scalar.modulus
    limbs = chip_smoke.random_scalars(np.random.default_rng(1), N, q)
    scalars = chip_smoke.host_ints(limbs)
    got = best_msm(curve, jnp.asarray(limbs), ck.points, assume_distinct=True)
    want = gold.msm([sum(s * e for s, e in zip(scalars, exps)) % q], [g])
    assert not got.is_identity
    assert got == want


@pytest.mark.parametrize("padding", ["key_points", "identities"])
def test_padded_commit_matches_gold(padding, keys):
    """n = N + 256 pads to 2N: with the key's own points when the key holds
    2N (a commit through `CommitmentKey.commit`), else with identities."""
    ck, exps, g = keys[BN256_G1.spec.name]
    q = BN256_G1.spec.scalar.modulus
    n = N + 256
    limbs = chip_smoke.random_scalars(np.random.default_rng(3), n, q)
    scalars = chip_smoke.host_ints(limbs)
    if padding == "key_points":
        got = ck.commit(jnp.asarray(limbs))
    else:
        pts = Points(*(c[:n] for c in ck.points))
        got = best_msm(BN256_G1, jnp.asarray(limbs), pts, assume_distinct=True)
    want = gold.msm([sum(s * e for s, e in zip(scalars, exps)) % q], [g])
    assert not got.is_identity
    assert got == want


def test_msm_many_matches_best_msm(keys):
    """The batched program equals one `best_msm` per vector."""
    ck, _, _ = keys[GRUMPKIN.spec.name]
    rng = np.random.default_rng(2)
    batch = jnp.asarray(np.stack(
        [chip_smoke.random_scalars(rng, N, GRUMPKIN.fs.p) for _ in range(2)]
    ))
    got = msm_many(GRUMPKIN, batch, ck.points, assume_distinct=True)
    want = [best_msm(GRUMPKIN, batch[i], ck.points, assume_distinct=True) for i in range(2)]
    assert got == want


def test_smoke_msm_check_runs_on_cpu(keys):
    """chip_smoke's phase-3 MSM check (device MSM vs the C++ host Pippenger
    and gold) at a tiny size, called directly."""
    ck, _, _ = keys[BN256_G1.spec.name]
    assert chip_smoke.check_msm(ck, KEY_LOG) >= 0
