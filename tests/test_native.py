"""Native C++ host runtime vs the python gold oracle.

Covers the host-side analogue of reference src/commitment.rs's
`best_multiexp` path plus batch field ops (reference does these in Rust
via halo2curves/ff; here it's `sirius_tpu/native/host_field.cpp`)."""

import random

import pytest

from sirius_tpu import native
from sirius_tpu.fields import gold
from sirius_tpu.fields.constants import bn256_g1, grumpkin

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native lib unavailable: {native.load_error()}"
)

RNG = random.Random(0xC0FFEE)


def _rand_elems(p, n):
    return [RNG.randrange(p) for _ in range(n)]


@pytest.mark.parametrize("spec", [bn256_g1.base, bn256_g1.scalar])
def test_field_batch_ops(spec):
    p = spec.modulus
    f = native.get_field(p)
    a, b = _rand_elems(p, 64), _rand_elems(p, 64)
    assert f.mul(a, b) == [(x * y) % p for x, y in zip(a, b)]
    assert f.add(a, b) == [(x + y) % p for x, y in zip(a, b)]
    assert f.sub(a, b) == [(x - y) % p for x, y in zip(a, b)]
    # edge values
    edge = [0, 1, p - 1, p - 2]
    assert f.mul(edge, edge) == [(x * x) % p for x in edge]
    assert f.add([p - 1], [1]) == [0]


def test_inv_batch_matches_fermat():
    p = bn256_g1.scalar.modulus
    f = native.get_field(p)
    a = _rand_elems(p, 33) + [1, p - 1]
    out = f.inv_batch(a)
    for x, ix in zip(a, out):
        assert (x * ix) % p == 1
    # inv(0) := 0 convention, and zeros must not poison neighbours
    a2 = [5, 0, 7]
    out2 = f.inv_batch(a2)
    assert out2[1] == 0
    assert (a2[0] * out2[0]) % p == 1 and (a2[2] * out2[2]) % p == 1


def _rand_points(curve, n):
    g = gold.AffinePoint(curve, curve.gx, curve.gy)
    return [g.mul(RNG.randrange(2, curve.scalar.modulus)) for _ in range(n)]


@pytest.mark.parametrize("curve", [bn256_g1, grumpkin])
def test_msm_matches_gold(curve):
    n = 57
    pts = _rand_points(curve, n)
    scalars = _rand_elems(curve.scalar.modulus, n)
    expect = gold.msm(scalars, pts)
    got = native.native_msm(curve, pts, scalars)
    assert (got.x, got.y) == (expect.x, expect.y)


def test_msm_edge_cases():
    curve = bn256_g1
    g = gold.AffinePoint(curve, curve.gx, curve.gy)
    # zero scalars + identity points mixed in
    pts = [g, gold.identity(curve), g.mul(7), g]
    scalars = [0, 5, 3, curve.scalar.modulus - 1]
    expect = gold.msm(scalars, pts)
    got = native.native_msm(curve, pts, scalars)
    assert (got.x, got.y) == (expect.x, expect.y)
    # all-zero -> infinity
    got0 = native.native_msm(curve, [g, g], [0, 0])
    assert got0.is_identity
    # single point, scalar 1
    got1 = native.native_msm(curve, [g], [1])
    assert (got1.x, got1.y) == (g.x, g.y)


def test_commit_native_backend_matches_tpu_path(monkeypatch):
    from sirius_tpu.curves.jpoint import BN256_G1
    from sirius_tpu.ops.commitment import CommitmentKey

    # window_bits=8: the 2^16-bucket XLA kernel is too big for a CPU test
    ck = CommitmentKey.setup(BN256_G1, 5, b"test-native-commit", window_bits=8)
    v = _rand_elems(bn256_g1.scalar.modulus, 32)
    monkeypatch.delenv("SIRIUS_TPU_COMMIT_BACKEND", raising=False)
    c_device = ck.commit(v)
    monkeypatch.setenv("SIRIUS_TPU_COMMIT_BACKEND", "native")
    c_native = ck.commit(v)
    assert (c_native.x, c_native.y) == (c_device.x, c_device.y)


def test_msm_window_sizes_agree():
    curve = bn256_g1
    pts = _rand_points(curve, 21)
    scalars = _rand_elems(curve.scalar.modulus, 21)
    base = native.native_msm(curve, pts, scalars, cbits=8)
    for cbits in (4, 13, 16):
        got = native.native_msm(curve, pts, scalars, cbits=cbits)
        assert (got.x, got.y) == (base.x, base.y)
