"""Sangria NIFS: Nova-style folding for relaxed PLONK.

Replaces reference `src/nifs/sangria/{mod,accumulator}.rs` (SURVEY.md §2.4).
Cross-term evaluation is the degree-grouped homogeneous gate evaluated
row-parallel on device; witness folds are device axpys; commitment folds are
host single-point scalar muls; the transcript RO runs on host between the
device phases (SURVEY.md §5 controller design).

MARKERS_LEN: the first instance column ("consistency markers") is folded by
r; remaining step-circuit instance columns accumulate via a Poseidon hash
chain (`SCInstancesHashAcc`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from ..fields import gold
from ..fields.constants import CurveSpec, FieldSpec
from ..ops.commitment import CommitmentKey
from ..ops.poseidon import PoseidonHash, poseidon_spec
from ..plonk.eval import PlonkEvalDomain
from ..plonk.sps import run_sps_protocol, sps_verify
from ..plonk.structure import PlonkInstance, PlonkStructure, PlonkTrace, PlonkWitness
from ..util.ro import DEFAULT_R_F, DEFAULT_R_P, DEFAULT_RATE, DEFAULT_T, NUM_CHALLENGE_BITS

CONSISTENCY_MARKERS_COUNT = 2

# compiled witness-fold cache: (field, rounds, cross-terms) -> jitted fn
_FOLD_COMPILED: dict = {}

# inverse-Vandermonde cache for cross-term interpolation: (p, D) -> rows
_VAND_INV: dict = {}


def _vandermonde_inv(p: int, D: int) -> list[list[int]]:
    """Rows k=0..D of V^-1 for the points x_j = j (j=0..D) mod p, i.e.
    out[k][j] = coefficient of X^k in the Lagrange basis poly L_j(X).
    T_k = sum_j out[k][j] * Q(j) recovers polynomial coefficients from
    point evaluations."""
    got = _VAND_INV.get((p, D))
    if got is not None:
        return got
    rows = [[0] * (D + 1) for _ in range(D + 1)]
    for j in range(D + 1):
        # L_j(X) = prod_{i != j} (X - i) / (j - i)
        coeffs = [1]
        denom = 1
        for i in range(D + 1):
            if i == j:
                continue
            denom = denom * (j - i) % p
            # multiply coeffs by (X - i)
            nxt = [0] * (len(coeffs) + 1)
            for d, c in enumerate(coeffs):
                nxt[d] = (nxt[d] - i * c) % p
                nxt[d + 1] = (nxt[d + 1] + c) % p
            coeffs = nxt
        dinv = pow(denom, -1, p)
        for k, c in enumerate(coeffs):
            rows[k][j] = c * dinv % p
    _VAND_INV[(p, D)] = rows
    return rows


class SangriaError(Exception):
    pass


class VerifyError(Exception):
    pass


# ---------------------------------------------------------------------------
# SC-instance hash accumulator
# (reference `src/ivc/sangria/instances_accumulator_computation.rs`)
# ---------------------------------------------------------------------------


def absorb_in_sc_instances_accumulator(
    curve: CurveSpec, acc: int, instances: Sequence[Sequence[int]]
) -> int:
    """acc' = Poseidon_base(acc, instances...) cast back to scalar."""
    base, scalar = curve.base, curve.scalar
    spec = poseidon_spec(base, DEFAULT_T, DEFAULT_RATE, DEFAULT_R_F, DEFAULT_R_P)
    ro = PoseidonHash(spec)
    ro.absorb_field(acc % base.modulus)
    for inst in instances:
        for v in inst:
            ro.absorb_field(v % base.modulus)
    return ro.squeeze(base.num_bits) % scalar.modulus


def get_initial_sc_instances_accumulator(curve: CurveSpec) -> int:
    """Chain seed: literal 0, so that `from_instance` (absorb(0, sc)) equals
    one replay step from the initial value and `is_sat_pub_instances` can
    walk the full per-step instance list from the start."""
    return 0


# ---------------------------------------------------------------------------
# Relaxed accumulator
# ---------------------------------------------------------------------------


@dataclass
class RelaxedPlonkInstance:
    """Reference `accumulator.rs:89-120`."""

    W_commitments: list  # gold.AffinePoint
    consistency_markers: list[int]  # MARKERS_LEN scalars
    challenges: list[int]
    E_commitment: object  # gold.AffinePoint
    u: int
    # None or int hash accumulator
    sc_instances_hash_acc: Optional[int]

    @staticmethod
    def new(curve: CurveSpec, num_challenges: int, num_witness: int, num_sc_instances: int,
            markers_len: int = CONSISTENCY_MARKERS_COUNT) -> "RelaxedPlonkInstance":
        return RelaxedPlonkInstance(
            W_commitments=[gold.identity(curve)] * num_witness,
            consistency_markers=[0] * markers_len,
            challenges=[0] * num_challenges,
            E_commitment=gold.identity(curve),
            # Nova's trivially-satisfying relaxed instance: u = 0 (with u = 1
            # a zero accumulator violates any gate carrying fixed-constant
            # terms; the reference's DEFAULT_u = 1 only works because its
            # accumulators always start as relaxations of real traces —
            # PARITY.md item 9)
            u=0,
            sc_instances_hash_acc=(
                None
                if num_sc_instances == 0
                else get_initial_sc_instances_accumulator(curve)
            ),
        )

    @staticmethod
    def from_instance(curve: CurveSpec, u: PlonkInstance, markers_len: int = CONSISTENCY_MARKERS_COUNT) -> "RelaxedPlonkInstance":
        """Reference `From<FoldablePlonkInstance>` (`accumulator.rs:123-157`)."""
        assert len(u.instances[0]) == markers_len, "first instance column must hold markers"
        sc = u.instances[1:]
        return RelaxedPlonkInstance(
            W_commitments=list(u.W_commitments),
            consistency_markers=list(u.instances[0]),
            challenges=list(u.challenges),
            E_commitment=gold.identity(curve),
            u=1,
            sc_instances_hash_acc=(
                absorb_in_sc_instances_accumulator(curve, 0, sc) if sc else None
            ),
        )

    def fold(self, curve: CurveSpec, U2: PlonkInstance, cross_term_commits: Sequence,
             r: int) -> "RelaxedPlonkInstance":
        """Reference `accumulator.rs:201-264`."""
        q = curve.scalar.modulus
        W = [w1.add(w2.mul(r)) for w1, w2 in zip(self.W_commitments, U2.W_commitments)]
        markers = [
            (a + r * b) % q
            for a, b in zip(self.consistency_markers, U2.instances[0])
        ]
        challenges = [(a + r * b) % q for a, b in zip(self.challenges, U2.challenges)]
        u = (self.u + r) % q
        comm_E = self.E_commitment
        r_pow = r
        for tk in cross_term_commits:
            comm_E = comm_E.add(tk.mul(r_pow))
            r_pow = r_pow * r % q
        sc_acc = self.sc_instances_hash_acc
        if sc_acc is not None:
            sc_acc = absorb_in_sc_instances_accumulator(curve, sc_acc, U2.instances[1:])
        return RelaxedPlonkInstance(W, markers, challenges, comm_E, u, sc_acc)

    def absorb_into(self, ro: PoseidonHash, base_modulus: int):
        """Absorb order (reference `accumulator.rs:316-347`): W commitments,
        [markers | challenges | u] cast to base, E commitment, sc-hash-acc
        (zero when None)."""
        for c in self.W_commitments:
            ro.absorb_point(c)
        for v in [*self.consistency_markers, *self.challenges, self.u]:
            ro.absorb_field(v % base_modulus)
        ro.absorb_point(self.E_commitment)
        ro.absorb_field(
            0 if self.sc_instances_hash_acc is None else self.sc_instances_hash_acc % base_modulus
        )

    def clone(self):
        return RelaxedPlonkInstance(
            list(self.W_commitments),
            list(self.consistency_markers),
            list(self.challenges),
            self.E_commitment,
            self.u,
            self.sc_instances_hash_acc,
        )


@dataclass
class RelaxedPlonkWitness:
    """W rounds + error vector E, device-resident (reference
    `accumulator.rs:485-520`)."""

    W: list[jnp.ndarray]
    E: jnp.ndarray  # (n, L)

    @staticmethod
    def from_regular(w: PlonkWitness, k: int, field) -> "RelaxedPlonkWitness":
        return RelaxedPlonkWitness(list(w.W), field.zeros((1 << k,)))

    def fold(self, field, W2: PlonkWitness, cross_terms: Sequence[jnp.ndarray], r: int) -> "RelaxedPlonkWitness":
        """W += r*W2 elementwise; E += sum r^k T_k (reference
        `accumulator.rs:364-404`)."""
        f = field
        r_dev = f.encode([r])[0]
        from ..parallel.context import get_mesh, replicated_sharding, row_sharding

        mesh = get_mesh()
        if mesh is not None:
            # explicit row shardings need every row count divisible by the
            # mesh; fall back to GSPMD inference otherwise
            nd = mesh.devices.size
            if any(a.shape[0] % nd for a in [*self.W, *W2.W, self.E, *cross_terms]):
                mesh = None
        key = (f.spec.name, len(self.W), len(cross_terms), mesh)
        fold_all = _FOLD_COMPILED.get(key)
        if fold_all is None:
            from ..fields.jfield_lf import from_lf, lf_for, to_lf

            flf = lf_for(f)

            def run(Ws1, Ws2, E, Ts, r_m):
                r_lf = jnp.moveaxis(r_m, -1, 0)
                newW = [
                    from_lf(flf.add(to_lf(w1), flf.mul(r_lf[:, None], to_lf(w2))))
                    for w1, w2 in zip(Ws1, Ws2)
                ]
                E_lf = to_lf(E)
                r_pow = r_lf
                for T in Ts:
                    E_lf = flf.add(E_lf, flf.mul(r_pow[:, None], to_lf(T)))
                    r_pow = flf.mul(r_pow, r_lf)
                return newW, from_lf(E_lf)

            run.__name__ = f"sangria_fold_w{len(self.W)}_t{len(cross_terms)}"
            if mesh is None:
                fold_all = jax.jit(run)
            else:
                # explicit shardings: every witness/error/cross-term array
                # stays row-sharded through the axpy (elementwise — no
                # collectives), the scalar r is replicated; prevents GSPMD
                # from inferring mixed layouts (round-3 dryrun remat)
                rows, repl = row_sharding(), replicated_sharding()
                fold_all = jax.jit(
                    run,
                    in_shardings=(rows, rows, rows, rows, repl),
                    out_shardings=(rows, rows),
                )
            _FOLD_COMPILED[key] = fold_all

        W1s, W2s, E, Ts = list(self.W), list(W2.W), self.E, list(cross_terms)
        if mesh is not None:
            # jit in_shardings require args to ALREADY carry the requested
            # sharding; device_put is a no-op for arrays placed row-sharded
            # by the SPS/eval stages and a deliberate reshard otherwise
            rows = row_sharding()
            W1s = [jax.device_put(w, rows) for w in W1s]
            W2s = [jax.device_put(w, rows) for w in W2s]
            E = jax.device_put(E, rows)
            Ts = [jax.device_put(t, rows) for t in Ts]
            r_dev = jax.device_put(r_dev, replicated_sharding())
        newW, newE = fold_all(W1s, W2s, E, Ts, r_dev)
        return RelaxedPlonkWitness(newW, newE)


@dataclass
class RelaxedPlonkTrace:
    U: RelaxedPlonkInstance
    W: RelaxedPlonkWitness


@dataclass
class ProverParam:
    S: PlonkStructure
    pp_digest: tuple[int, int]  # affine coords of the digest point (base field)


@dataclass
class VerifierParam:
    pp_digest: tuple[int, int]


# ---------------------------------------------------------------------------
# VanillaFS
# ---------------------------------------------------------------------------


class VanillaFS:
    """Reference `VanillaFS` (`nifs/sangria/mod.rs:66`).  All methods are
    static; the curve context rides along explicitly."""

    @staticmethod
    def setup_params(pp_digest_point, S: PlonkStructure):
        if pp_digest_point.is_identity:
            coords = (0, 0)
        else:
            coords = (pp_digest_point.x, pp_digest_point.y)
        return ProverParam(S, coords), VerifierParam(coords)

    @staticmethod
    def generate_plonk_trace(
        ck: CommitmentKey,
        instances,
        witness,
        pp: ProverParam,
        ro_nark: PoseidonHash,
        markers_len: int = CONSISTENCY_MARKERS_COUNT,
    ) -> PlonkTrace:
        tr = run_sps_protocol(pp.S, ck, instances, witness, ro_nark)
        if len(tr.u.instances[0]) != markers_len:
            raise SangriaError("first instance column must hold consistency markers")
        return tr

    @staticmethod
    def commit_cross_terms(
        ck: CommitmentKey,
        S: PlonkStructure,
        U1: RelaxedPlonkInstance,
        W1: RelaxedPlonkWitness,
        U2: PlonkInstance,
        W2: PlonkWitness,
    ):
        """Reference `nifs/sangria/mod.rs:102-158`: the cross terms T_k
        (degrees 1..deg) of P_homo(acc + X*inc).

        Computed by EVALUATION + INTERPOLATION instead of symbolic
        degree-grouping (round-5 compile-wall fix): Q(X) = P_homo(W1 + X*W2,
        ch1 + X*ch2, u1 + X*u2) is a degree-<=D polynomial in X whose
        coefficient vectors are EXACTLY the grouped terms (that is the
        definition of `GroupedPoly`, reference `grouped_poly.rs:88-138`), so
        evaluating Q at X = 0..D and applying the inverse Vandermonde
        recovers T_1..T_D bit-exactly.  This reuses the SAME compiled
        homogeneous-gate program as `is_sat_accumulation` (one witness set)
        and the shared witness-axpy program — the symbolic grouped-poly
        mega-program (5 giant expressions, the single biggest XLA compile in
        the cyclefold pipeline) is gone from the hot path.  `GroupedPoly`
        itself remains setup-time machinery for degree/shape derivation."""
        f = S.field
        p = f.p
        D = len(S.custom_gates_lookup_compressed.grouped) - 1
        if D < 1:
            return [], []
        from .protogalaxy import _fold_w_fn

        expr = S.custom_gates_lookup_compressed.homogeneous
        ch1 = [*U1.challenges, U1.u]
        ch2 = [*U2.challenges, 1]
        fold = _fold_w_fn(f, 2, len(W1.W))
        W_stacked = [jnp.stack([w1, w2]) for w1, w2 in zip(W1.W, W2.W)]
        evals = []
        for X in range(D + 1):
            WX = list(W1.W) if X == 0 else fold(f.encode([1, X]), W_stacked)
            chX = [f.encode([(a + X * b) % p])[0] for a, b in zip(ch1, ch2)]
            dom = PlonkEvalDomain(S, challenges=chX, W1s=list(WX), W2s=[])
            evals.append(dom.evaluate_compiled([expr])[0])  # (n, L)
        vinv = _vandermonde_inv(p, D)
        comb = _fold_w_fn(f, D + 1, 1)
        E_stacked = [jnp.stack(evals)]
        cross_terms = [
            comb(f.encode([vinv[k][j] for j in range(D + 1)]), E_stacked)[0]
            for k in range(1, D + 1)
        ]
        if len(cross_terms) > 1 and hasattr(ck, "commit_device_many"):
            # every T_k over the shared key points
            cross_term_commits = ck.commit_device_many(jnp.stack(cross_terms))
        else:
            cross_term_commits = [ck.commit_device(T) for T in cross_terms]
        return cross_terms, cross_term_commits

    @staticmethod
    def generate_challenge(
        pp_digest: tuple[int, int],
        ro_acc: PoseidonHash,
        U1: RelaxedPlonkInstance,
        U2: PlonkInstance,
        cross_term_commits,
        base_modulus: int,
    ) -> int:
        """r = RO(pp || U1 || U2 || T-commits) (reference
        `nifs/sangria/mod.rs:162-179`)."""
        ro_acc.absorb_field(pp_digest[0] % base_modulus)
        ro_acc.absorb_field(pp_digest[1] % base_modulus)
        U1.absorb_into(ro_acc, base_modulus)
        # U2 absorb: W_commitments, instances, challenges (plonk/mod.rs:263-273)
        for c in U2.W_commitments:
            ro_acc.absorb_point(c)
        for inst in U2.instances:
            for v in inst:
                ro_acc.absorb_field(v % base_modulus)
        for ch in U2.challenges:
            ro_acc.absorb_field(ch % base_modulus)
        for c in cross_term_commits:
            ro_acc.absorb_point(c)
        return ro_acc.squeeze(NUM_CHALLENGE_BITS)

    @staticmethod
    def prove(
        ck: CommitmentKey,
        pp: ProverParam,
        ro_acc: PoseidonHash,
        accumulator: RelaxedPlonkTrace,
        incoming: PlonkTrace,
    ):
        """Fold one incoming trace into the accumulator (reference
        `nifs/sangria/mod.rs:253-277`)."""
        curve = ck.curve.spec
        S = pp.S
        U1, W1 = accumulator.U, accumulator.W
        U2, W2 = incoming.u, incoming.w

        from ..util.profiling import span

        with span("sangria_cross_terms"):
            cross_terms, cross_term_commits = VanillaFS.commit_cross_terms(
                ck, S, U1, W1, U2, W2
            )
        with span("sangria_challenge"):
            r = VanillaFS.generate_challenge(
                pp.pp_digest, ro_acc, U1, U2, cross_term_commits, curve.base.modulus
            )
        with span("sangria_fold"):
            U = U1.fold(curve, U2, cross_term_commits, r)
            W = W1.fold(S.field, W2, cross_terms, r)
        return RelaxedPlonkTrace(U, W), cross_term_commits

    @staticmethod
    def verify(
        vp: VerifierParam,
        curve: CurveSpec,
        ro_nark: PoseidonHash,
        ro_acc: PoseidonHash,
        U1: RelaxedPlonkInstance,
        U2: PlonkInstance,
        cross_term_commits,
    ) -> RelaxedPlonkInstance:
        """Instance-side fold (reference `nifs/sangria/mod.rs:296-311`)."""
        sps_verify(U2, ro_nark)
        r = VanillaFS.generate_challenge(
            vp.pp_digest, ro_acc, U1, U2, cross_term_commits, curve.base.modulus
        )
        return U1.fold(curve, U2, cross_term_commits, r)

    # -- satisfaction checks (reference `nifs/sangria/mod.rs:334-502`) ---------
    @staticmethod
    def is_sat_accumulation(S: PlonkStructure, acc: RelaxedPlonkTrace) -> None:
        f = S.field
        challenges = [*acc.U.challenges, acc.U.u]
        dom = PlonkEvalDomain(
            S,
            challenges=[f.encode([c % f.p])[0] for c in challenges],
            W1s=list(acc.W.W),
            W2s=[],
        )
        expr = S.custom_gates_lookup_compressed.homogeneous
        out = dom.evaluate_compiled([expr])[0]
        mism = ~f.eq(out, acc.W.E)
        count = int(mism.sum())
        if count:
            raise VerifyError(f"accumulation gate mismatch on {count}/{S.n} rows")
        from ..plonk.satisfy import is_sat_log_derivative

        if not is_sat_log_derivative(S, PlonkWitness(acc.W.W)):
            raise VerifyError("log derivative not satisfied")

    @staticmethod
    def is_sat_permutation(S: PlonkStructure, acc: RelaxedPlonkTrace) -> None:
        """P'@Z == Z with step-circuit instance columns cut out and padded
        (reference `nifs/sangria/mod.rs:385-453`); one device gather+compare
        (P is a permutation, so P@Z==Z <=> Z[idx]==Z)."""
        from ..plonk.permutation import device_perm_mismatches, perm_index_vector

        f = S.field
        n = S.n
        PAD = 0xFFFFFFF
        head = list(acc.U.consistency_markers)
        for io_len in S.num_io[1:]:
            head.extend([PAD] * io_len)
        total = len(head) + n * S.num_advice_columns
        idx = perm_index_vector(
            (id(S), "sangria-cut"),
            lambda: S.permutation_data.rm_copy_constraints(range(1, len(S.num_io))).matrix(
                S.k, S.num_io, S.num_advice_columns
            ),
            total,
        )
        mismatch = device_perm_mismatches(f, idx, head, acc.W.W[0][: n * S.num_advice_columns])
        if mismatch:
            raise VerifyError(f"permutation mismatch on {mismatch} entries")

    @staticmethod
    def is_sat_witness_commit(ck: CommitmentKey, acc: RelaxedPlonkTrace) -> None:
        pairs = list(zip(acc.W.W, acc.U.W_commitments)) + [
            (acc.W.E, acc.U.E_commitment)
        ]
        check = getattr(ck, "batched_commit_check", None)
        if check is not None:
            bad = check(pairs)
            if bad:
                last = len(pairs) - 1
                names = ["E" if i == last else f"round {i}" for i in bad]
                raise VerifyError(f"witness commitment mismatch: {', '.join(names)}")
            return
        for i, (Wi, Ci) in enumerate(pairs[:-1]):
            if ck.commit_device(Wi) != Ci:
                raise VerifyError(f"witness commitment mismatch round {i}")
        if ck.commit_device(acc.W.E) != acc.U.E_commitment:
            raise VerifyError("E commitment mismatch")

    @staticmethod
    def is_sat_pub_instances(curve: CurveSpec, acc: RelaxedPlonkTrace, all_instances) -> None:
        """Replay the hash chain over every folded trace's step-circuit
        instances (reference `nifs/sangria/mod.rs:476-502`)."""
        if acc.U.sc_instances_hash_acc is None:
            return
        h = get_initial_sc_instances_accumulator(curve)
        for instances in all_instances:
            h = absorb_in_sc_instances_accumulator(curve, h, instances[1:])
        if h != acc.U.sc_instances_hash_acc:
            raise VerifyError("step-circuit instances hash mismatch")

    @staticmethod
    def is_sat(ck: CommitmentKey, S: PlonkStructure, acc: RelaxedPlonkTrace, all_instances) -> list:
        errors = []
        for check in (
            lambda: VanillaFS.is_sat_accumulation(S, acc),
            lambda: VanillaFS.is_sat_permutation(S, acc),
            lambda: VanillaFS.is_sat_witness_commit(ck, acc),
            lambda: VanillaFS.is_sat_pub_instances(ck.curve.spec, acc, all_instances),
        ):
            try:
                check()
            except VerifyError as e:
                errors.append(e)
        return errors
