"""Spread-table SHA-256 (table16-class workload): chip + circuit tests at
CPU scale (half_bits=8 -> 256-row table), reference
`examples/sha256/table16/` behavior.

The full production configuration (half_bits=16, 2^16-row table, k=17)
runs on the GPU via examples/sha256_table16.py and the bench."""

import os

import pytest

from sirius_tpu.fields.constants import bn256_fq, bn256_fr
from sirius_tpu.frontend.runner import CircuitRunner
from sirius_tpu.gadgets.spread_sha256 import (
    SIGMA0_SMALL,
    SIGMA1_BIG,
    SpreadChip,
    SpreadSha256StepCircuit,
    _spread,
)
from sirius_tpu.gadgets.main_gate import MainGate, RegionCtx
from sirius_tpu.ops.poseidon import PoseidonHash, poseidon_spec
from sirius_tpu.util.testing import MockCommitmentKey
from sirius_tpu.curves.jpoint import BN256_G1
from sirius_tpu.plonk import satisfy
from sirius_tpu.plonk.sps import run_sps_protocol

SLOW = os.environ.get("SIRIUS_TPU_SLOW_TESTS") != "1"


def create_ro():
    return PoseidonHash(poseidon_spec(bn256_fq, 3, 2, 4, 3))


def _rotr(x, r):
    return ((x >> r) | (x << (32 - r))) & 0xFFFFFFFF


class _StepAdapter:
    """Plain circuit wrapper: witness z_in, run the step, pin z_out to an
    instance cell so satisfaction covers the whole pipeline."""

    def __init__(self, step, z_in):
        self.step = step
        self.z_in = z_in
        self.corrupt_lookup = None  # (row_offset_cb) test hook

    def configure(self, cs):
        cfg = self.step.configure(cs)
        inst = cs.instance_column()
        return cfg, inst

    def instances(self, p):
        z_out = self.step.process_step([self.z_in], None, bn256_fr)[0]
        return [[self.z_in % p, z_out % p]]

    def synthesize(self, config, asn):
        cfg, inst = config
        mg = MainGate(cfg[0], asn.p)
        ctx = RegionCtx(asn)
        z_cell = mg.assign_value(ctx, self.z_in)
        asn.copy(z_cell.column, z_cell.row, inst, 0)
        out = self.step.synthesize_step(cfg, ctx, [z_cell])
        asn.copy(out[0].column, out[0].row, inst, 1)
        if self.corrupt_lookup is not None:
            self.corrupt_lookup(asn, cfg)


def _run(step, z_in, k, ck, corrupt=None):
    circ = _StepAdapter(step, z_in)
    circ.corrupt_lookup = corrupt
    inst = circ.instances(bn256_fr.modulus)
    runner = CircuitRunner(k, bn256_fr, circ, inst)
    S = runner.collect_plonk_structure()
    W = runner.collect_witness()
    tr = run_sps_protocol(S, ck, inst, W, create_ro())
    satisfy.is_sat(S, ck, create_ro(), tr.u, tr.w, check_commit=False)
    return S, tr


@pytest.fixture(scope="module")
def ck():
    # satisfaction tests (gates/lookups/permutation), not commitment tests:
    # 9 advice columns at k=12+ would need a 2^16 real key
    return MockCommitmentKey(BN256_G1)


def test_spread_helper():
    assert _spread(0b1011, 4) == 0b01000101
    assert _spread(0xFFFF, 16) == sum(1 << (2 * j) for j in range(16))


def test_reduced_round_circuit_satisfied(ck):
    """8-round H=8 compression: z_out matches the host model and the full
    trace satisfies gates + (dense, spread) lookups + permutation."""
    step = SpreadSha256StepCircuit(bn256_fr, half_bits=8, rounds=8)
    z_in = 0x0123456789ABCDEF0123456789ABCDEF
    S, tr = _run(step, z_in, k=12, ck=ck)
    assert S.num_challenges == 3  # vector lookup -> 3-round SPS


def test_sigma_matches_fips(ck):
    """The in-circuit Σ/σ identities agree with direct rotate-xor."""
    step = SpreadSha256StepCircuit(bn256_fr, half_bits=8, rounds=1)
    # independently verify the host-model identity the circuit encodes
    for x in (0x6A09E667, 0xDEADBEEF, 0x00000001, 0xFFFFFFFF):
        assert (_rotr(x, 6) ^ _rotr(x, 11) ^ _rotr(x, 25)) == _sigma_host(x, SIGMA1_BIG)
        assert (_rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)) == _sigma_host(x, SIGMA0_SMALL)
    _run(step, 42, k=11, ck=ck)


def _sigma_host(x, rots):
    out = 0
    for kind, r in rots:
        out ^= _rotr(x, r) if kind == "rot" else (x >> r)
    return out


def test_lookup_violation_detected(ck):
    """Corrupting a looked-up spread cell must break the log-derivative
    check (the lookup is what makes the bitwise ops sound)."""
    step = SpreadSha256StepCircuit(bn256_fr, half_bits=8, rounds=4)

    def corrupt(asn, cfg):
        _mg, (_l_dense, l_spread, sel), _t = cfg
        row = next(r for r in range(asn.n) if asn.selectors[sel.index][r])
        asn.advice[l_spread.index][row] = (asn.advice[l_spread.index][row] + 1) % asn.p

    with pytest.raises(satisfy.IsSatError):
        _run(step, 7, k=12, ck=ck, corrupt=corrupt)


@pytest.mark.skipif(SLOW, reason="set SIRIUS_TPU_SLOW_TESTS=1")
def test_full_64round_fips_exact(ck):
    """Full 64-round compression at H=8 (k=15): circuit satisfies and the
    step function is the hashlib-validated FIPS model."""
    step = SpreadSha256StepCircuit(bn256_fr, half_bits=8, rounds=64)
    _run(step, 0xDEADBEEFCAFE, k=15, ck=ck)
