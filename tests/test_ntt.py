"""NTT: device kernel vs gold model vs reference inline golden vector."""

import numpy as np
import pytest

from sirius_tpu.fields import gold
from sirius_tpu.fields.constants import bn256_fr, pasta_fp
from sirius_tpu.fields.jfield import FR, PASTA_FP
from sirius_tpu.ops.ntt import ntt_ctx

# reference src/fft.rs:241-252: fft([0..8]) over bn256 Fr
GOLDEN_FFT8 = [
    28,
    68918385373930674424918168212551896122229959265833979749191472831399925654,
    17631683881184975370165255887551781615748388533673675138856,
    68918385373930639161550405842601155791718184162270748252414405484049647934,
    21888242871839275222246405745257275088548364400416034343698204186575808495613,
    21819324486465344583084855339414673932756646216253763595445789781091758847675,
    21888242871839275204614721864072299718383108512864252727949815652902133356753,
    21819324486465344547821487577044723192426134441150200363949012713744408569955,
]


def test_gold_fft_reference_vector():
    assert gold.fft(list(range(8)), bn256_fr) == GOLDEN_FFT8


def test_device_fft_reference_vector():
    ctx = ntt_ctx(bn256_fr, 3)
    out = FR.decode(ctx.fft(FR.encode(list(range(8)))))
    assert out == GOLDEN_FFT8


@pytest.mark.parametrize("k", [4, 6])
def test_fft_ifft_roundtrip(k, rng):
    ctx = ntt_ctx(bn256_fr, k)
    xs = [int(x) for x in rng.integers(0, 2**62, size=1 << k)]
    a = FR.encode(xs)
    assert FR.decode(ctx.ifft(ctx.fft(a))) == xs
    # vs gold
    assert FR.decode(ctx.fft(a)) == gold.fft(xs, bn256_fr)


@pytest.mark.parametrize("k", [5])
def test_coset_roundtrip(k, rng):
    ctx = ntt_ctx(bn256_fr, k)
    xs = [int(x) for x in rng.integers(0, 2**62, size=1 << k)]
    a = FR.encode(xs)
    assert FR.decode(ctx.coset_ifft(ctx.coset_fft(a))) == xs
    assert FR.decode(ctx.coset_fft(a)) == gold.coset_fft(xs, bn256_fr)


def test_pasta_fft(rng):
    ctx = ntt_ctx(pasta_fp, 4)
    xs = [int(x) for x in rng.integers(0, 2**62, size=16)]
    assert PASTA_FP.decode(ctx.fft(PASTA_FP.encode(xs))) == gold.fft(xs, pasta_fp)


def test_sharded_fft_multichip():
    """NTT jitted over an 8-device rows mesh: XLA/GSPMD inserts the
    inter-stage exchanges (SURVEY.md §2.8 'NTT stage all-to-all')."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sirius_tpu.parallel.mesh import make_mesh

    k = 7
    ctx = ntt_ctx(bn256_fr, k)
    xs = [int(x) for x in np.random.default_rng(5).integers(0, 2**62, size=1 << k)]
    a = FR.encode(xs)

    mesh = make_mesh(8)
    sh = NamedSharding(mesh, P("rows", None))
    a_sharded = jax.device_put(a, sh)
    out = jax.jit(ctx._fft, static_argnames=("inverse",), in_shardings=(sh,), out_shardings=sh)(a_sharded)
    assert FR.decode(out) == gold.fft(xs, bn256_fr)


def test_four_step_matches_gold_and_ladder(rng):
    """k=10 engages the four-step (Bailey) path: check against the host gold
    model AND bit-exactness vs the flat-ladder oracle, both directions, plus
    the coset round-trip (the 1/n scale folds into the mid twiddle)."""
    import jax.numpy as jnp

    from sirius_tpu.fields.jfield_lf import from_lf, to_lf
    from sirius_tpu.ops.ntt import NTT

    k = 10
    ctx = NTT(FR, k)
    assert ctx.use_four_step
    xs = [int(x) for x in rng.integers(0, 2**62, size=1 << k)]
    al = jnp.asarray(to_lf(FR.encode(xs)))

    out = ctx.fft_lf(al)
    assert FR.decode(from_lf(out)) == gold.fft(xs, bn256_fr)
    back = ctx.ifft_lf(out)
    assert FR.decode(from_lf(back)) == xs

    # ladder oracle bit-exactness
    import os

    os.environ["SIRIUS_TPU_NTT_LADDER"] = "1"
    try:
        ladder_ctx = NTT(FR, k)
        assert not ladder_ctx.use_four_step
        want = ladder_ctx.fft_lf(al)
        assert jnp.array_equal(out, want)
    finally:
        del os.environ["SIRIUS_TPU_NTT_LADDER"]

    # coset round-trip through the four-step path
    a = FR.encode(xs)
    assert FR.decode(ctx.coset_ifft(ctx.coset_fft(a))) == xs


def test_fft_lf_matches_limb_last(rng):
    """Native limb-first entry agrees with the limb-last boundary API."""
    from sirius_tpu.fields.jfield_lf import from_lf, to_lf

    k = 5
    ctx = ntt_ctx(bn256_fr, k)
    xs = [int(x) for x in rng.integers(0, 2**62, size=1 << k)]
    a = FR.encode(xs)
    out_lf = from_lf(ctx.fft_lf(to_lf(a)))
    assert FR.decode(out_lf) == gold.fft(xs, bn256_fr)
    back = from_lf(ctx.ifft_lf(to_lf(out_lf)))
    assert FR.decode(back) == xs

