"""End-to-end Sangria IVC on the bn256/grumpkin 2-cycle (analogue of the
reference's `sangria_trivial` example + IVC debug-mode checks).

Uses the homomorphic MockCommitmentKey so the full protocol runs on CPU;
the real-MSM path is exercised separately (bench.py / examples on the GPU).
"""

import os

import pytest

if not os.environ.get("SIRIUS_TPU_SLOW_TESTS"):
    pytest.skip(
        "full IVC round-trip takes ~10 min on CPU; set SIRIUS_TPU_SLOW_TESTS=1 "
        "(verified in round-1 drive: fold_step + verify pass)",
        allow_module_level=True,
    )

from sirius_tpu.curves.jpoint import BN256_G1, GRUMPKIN
from sirius_tpu.ivc.sangria_ivc import IVC, PublicParams
from sirius_tpu.ivc.step_circuit import TrivialStepCircuit
from sirius_tpu.util.testing import MockCommitmentKey

K = 16


@pytest.fixture(scope="module")
def pp():
    return PublicParams(
        TrivialStepCircuit(arity=1),
        TrivialStepCircuit(arity=1),
        k1=K,
        k2=K,
        ck1=MockCommitmentKey(BN256_G1),
        ck2=MockCommitmentKey(GRUMPKIN),
    )


def test_sangria_ivc_trivial_two_steps(pp):
    ivc = IVC(pp, [0x11], [0x22])
    assert ivc.step == 1
    ivc.fold_step()
    assert ivc.step == 2
    errors = ivc.verify()
    assert not errors, errors


def test_sangria_ivc_poseidon_step():
    """Step circuit that registers its own gates (second MainGate config):
    raises the primary folding degree to 6 and adds an SPS compression
    challenge — both must be probed, not assumed (regression for the
    hardcoded cross-term-count/challenge-shape bug)."""
    from sirius_tpu.fields.constants import bn256_fr
    from sirius_tpu.gadgets.poseidon_step_circuit import PoseidonStepCircuit

    pp2 = PublicParams(
        PoseidonStepCircuit(bn256_fr, repeat_count=1),
        TrivialStepCircuit(arity=1),
        k1=K,
        k2=K,
        ck1=MockCommitmentKey(BN256_G1),
        ck2=MockCommitmentKey(GRUMPKIN),
    )
    assert pp2.primary_probe.num_cross_terms == 6
    assert pp2.primary_probe.num_challenges == 1
    ivc = IVC(pp2, [0x42], [0])
    ivc.fold_step()
    errors = ivc.verify()
    assert not errors, errors


def test_sangria_ivc_step_circuit_instances():
    """Step circuit exposing its own public instance column: values are
    hash-chained into SCInstancesHashAcc on- and off-circuit and replayed
    by is_sat (reference examples/instances.rs scope)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ex_instances", "examples/instances.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    from sirius_tpu.fields.constants import bn256_fr

    pp2 = PublicParams(
        mod.PublicPow5Circuit(bn256_fr),
        TrivialStepCircuit(arity=1),
        k1=K, k2=K,
        ck1=MockCommitmentKey(BN256_G1),
        ck2=MockCommitmentKey(GRUMPKIN),
    )
    assert pp2.primary_probe.sc_instance_lens == (1,)
    ivc = IVC(pp2, [3], [0])
    ivc.fold_step()
    errors = ivc.verify()
    assert not errors, errors
    # the accumulated hash must change when instances change
    assert ivc.primary_relaxed.U.sc_instances_hash_acc is not None


def test_sangria_ivc_merkle_step():
    """Merkle-update step circuit (authentication-path witness + Poseidon
    chip hashing) through one fold step."""
    from sirius_tpu.fields.constants import bn256_fr
    from sirius_tpu.gadgets.merkle_step_circuit import MerkleStepCircuit

    sc = MerkleStepCircuit(bn256_fr, depth=3)
    pp2 = PublicParams(
        sc,
        TrivialStepCircuit(arity=1),
        k1=K, k2=K,
        ck1=MockCommitmentKey(BN256_G1),
        ck2=MockCommitmentKey(GRUMPKIN),
    )
    ivc = IVC(pp2, [sc.tree.root], [0])
    ivc.fold_step()
    errors = ivc.verify()
    assert not errors, errors


def test_sangria_ivc_lookup_step():
    """Lookup-using step circuit: byte-table range checks upgrade the
    primary to the 2-round SPS (2 W commitments, 2 challenges, degree-10
    folding) — all shapes probed and folded on/off circuit.  k=17: the
    extra W/challenge folds overflow the 2^16 region."""
    from sirius_tpu.fields.constants import bn256_fr
    from sirius_tpu.gadgets.range_step_circuit import RangeCheckStepCircuit

    pp2 = PublicParams(
        RangeCheckStepCircuit(bn256_fr),
        TrivialStepCircuit(arity=1),
        k1=17, k2=17,
        ck1=MockCommitmentKey(BN256_G1),
        ck2=MockCommitmentKey(GRUMPKIN),
    )
    assert pp2.primary_probe.num_challenges == 2
    assert pp2.primary_probe.num_witness == 2
    ivc = IVC(pp2, [7], [0])
    ivc.fold_step()
    errors = ivc.verify()
    assert not errors, errors


def test_sangria_ivc_vector_lookup_step():
    """Vector (multi-column) lookup step circuit -> 3-round SPS (3 W
    commitments, 3 challenges), completing the 0/1/2/3-round SPS matrix."""
    from sirius_tpu.fields.constants import bn256_fr
    from sirius_tpu.gadgets.xor_step_circuit import XorStepCircuit

    pp2 = PublicParams(
        XorStepCircuit(bn256_fr),
        TrivialStepCircuit(arity=1),
        k1=17, k2=17,
        ck1=MockCommitmentKey(BN256_G1),
        ck2=MockCommitmentKey(GRUMPKIN),
    )
    assert pp2.primary_probe.num_challenges == 3
    assert pp2.primary_probe.num_witness == 3
    ivc = IVC(pp2, [5], [0])
    ivc.fold_step()
    errors = ivc.verify()
    assert not errors, errors


def test_sangria_ivc_sha256_step():
    """SHA-256 compression step circuit (~65k bitwise MainGate rows):
    circuit output is FIPS-exact (validated standalone vs hashlib-checked
    host model) and folds through the 2-cycle at k=17."""
    from sirius_tpu.fields.constants import bn256_fr
    from sirius_tpu.gadgets.sha256_step_circuit import Sha256StepCircuit

    pp2 = PublicParams(
        Sha256StepCircuit(bn256_fr),
        TrivialStepCircuit(arity=1),
        k1=17, k2=17,
        ck1=MockCommitmentKey(BN256_G1),
        ck2=MockCommitmentKey(GRUMPKIN),
    )
    ivc = IVC(pp2, [0xABCDEF], [0])
    ivc.fold_step()
    errors = ivc.verify()
    assert not errors, errors
