"""ProtoGalaxy NIFS: multi-instance folding with F/G/K polynomials.

Replaces reference `src/nifs/protogalaxy/{mod,accumulator,poly/*}.rs`
(SURVEY.md §2.4).  The transcript RO lives over the *scalar* field (no ECC:
commitments absorb as 64-bit x 20 limb decompositions of their base-field
coordinates, reference `BigUintPoint`).  The F/G tree reductions become
log-depth halving folds over device leaf arrays (SURVEY.md §2.8 item 7).

Documented deviation (PARITY.md): the reference's leaf indexer
(`plonk/mod.rs:714`) computes `row = index & total_row`, which collapses
every leaf to row 0; we use `row = index % total_row` so every row
contributes, matching the ProtoGalaxy paper.  Prover/verifier/is_sat remain
mutually consistent either way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from ..fields import gold
from ..fields.constants import CurveSpec
from ..ops.commitment import CommitmentKey
from ..ops.poseidon import PoseidonHash
from ..plonk.eval import PlonkEvalDomain
from ..plonk.sps import run_sps_protocol, sps_verify
from ..plonk.structure import PlonkInstance, PlonkStructure, PlonkTrace, PlonkWitness
from ..poly import lagrange
from ..poly.univariate import UnivariatePoly
from ..util.ro import MAX_BITS

# Limb geometry for commitment-coordinate decompositions.  The reference
# uses 64x20 (`ivc/cyclefold/mod.rs:26-29`); we use the sangria 32x10
# geometry everywhere (4x cheaper on-circuit rows, same 320-bit capacity) —
# a self-consistent deviation recorded in PARITY.md.
DEFAULT_LIMB_WIDTH = 32
DEFAULT_LIMBS_COUNT = 10


class ProtoGalaxyError(Exception):
    pass


class VerifyError(Exception):
    pass


def biguint_limbs(x: int, width: int = DEFAULT_LIMB_WIDTH, count: int = DEFAULT_LIMBS_COUNT) -> list[int]:
    """Little-endian fixed-width limb decomposition (reference
    `BigUintPoint`/`big_uint.rs`)."""
    mask = (1 << width) - 1
    return [(x >> (i * width)) & mask for i in range(count)]


def absorb_point_limbs(ro: PoseidonHash, pt, scalar_modulus: int):
    """Absorb a commitment as limb decompositions of its affine coords
    (identity -> (0,0)); reference `PlonkInstanceWrapper` absorb."""
    x, y = (0, 0) if pt.is_identity else (pt.x, pt.y)
    for v in biguint_limbs(x) + biguint_limbs(y):
        ro.absorb_field(v % scalar_modulus)


def absorb_instance(ro: PoseidonHash, u: PlonkInstance, q: int):
    for c in u.W_commitments:
        absorb_point_limbs(ro, c, q)
    for inst in u.instances:
        for v in inst:
            ro.absorb_field(v % q)
    for ch in u.challenges:
        ro.absorb_field(ch % q)


@dataclass
class Accumulator:
    """Reference `accumulator.rs:16-57`."""

    trace: PlonkTrace
    betas: list[int]
    e: int

    def clone(self):
        return Accumulator(self.trace.clone(), list(self.betas), self.e)


@dataclass
class AccumulatorInstance:
    ins: PlonkInstance
    betas: list[int]
    e: int

    @staticmethod
    def from_acc(acc: Accumulator) -> "AccumulatorInstance":
        return AccumulatorInstance(acc.trace.u.clone(), list(acc.betas), acc.e)

    def absorb_into(self, ro: PoseidonHash, q: int):
        """W limbs, instances, challenges, betas, e (reference
        `accumulator.rs:100-129`)."""
        absorb_instance(ro, self.ins, q)
        for b in self.betas:
            ro.absorb_field(b % q)
        ro.absorb_field(self.e % q)


@dataclass
class Proof:
    poly_F: UnivariatePoly
    poly_K: UnivariatePoly


@dataclass
class ProverParam:
    S: PlonkStructure
    pp_digest: tuple[int, int]

    def absorb_into(self, ro: PoseidonHash, q: int):
        ro.absorb_field(self.pp_digest[0] % q)
        ro.absorb_field(self.pp_digest[1] % q)


VerifierParam = ProverParam  # same absorb shape, no S needed for absorb


# ---------------------------------------------------------------------------
# Poly context / sizes (reference `poly/mod.rs:205-269,511-545`)
# ---------------------------------------------------------------------------


def _next_pow2(x: int) -> int:
    return 1 << max((x - 1).bit_length(), 0) if x > 1 else 1


def count_of_evaluation(S: PlonkStructure) -> int:
    return (1 << S.k) * len(S.gates)


def count_of_evaluation_with_padding(S: PlonkStructure) -> int:
    return _next_pow2(count_of_evaluation(S))


@dataclass
class PolyContext:
    S: PlonkStructure
    L: int  # number of incoming traces

    @property
    def instances_to_fold(self) -> int:
        n = self.L + 1
        assert n & (n - 1) == 0, "L+1 must be a power of two"
        return n

    @property
    def count_padded(self) -> int:
        return count_of_evaluation_with_padding(self.S)

    @property
    def betas_count(self) -> int:
        return self.count_padded.bit_length() - 1

    @property
    def fft_points_count_F(self) -> int:
        return _next_pow2(self.betas_count + 1)

    @property
    def max_gate_degree(self) -> int:
        ctx = self.S.query_index_ctx
        return max((g.degree(ctx) for g in self.S.gates), default=0)

    @property
    def fft_points_count_G(self) -> int:
        return _next_pow2(self.L * self.max_gate_degree + 1)

    @property
    def lagrange_domain(self) -> int:
        return self.instances_to_fold.bit_length() - 1

    @property
    def fft_log_domain_size_K(self) -> int:
        # NOTE: mirrors the reference exactly (`poly/mod.rs:263-268`), which
        # uses next_power_of_two(G_points + 1 - (L+1)) *as the log itself* —
        # an oversized but harmless domain (interpolating a polynomial on
        # more points than its degree recovers the same polynomial).
        v = max(self.fft_points_count_G + 1 - self.instances_to_fold, 1)
        return _next_pow2(v)


# ---------------------------------------------------------------------------
# Leaf evaluation + tree reductions (device)
#
# Each F/G/e pipeline below is ONE jitted XLA program (leaf gate sweep +
# log-depth weighted tree), batched over evaluation points where the leaves
# are shared.  The round-1 implementation dispatched every tree level (and a
# host `decode_one` per point) eagerly — ~9.5k tiny ops per `prove`, 85% of
# cyclefold `IVC::next` wall-clock.  Compiled fns are cached per structure.
# ---------------------------------------------------------------------------

_PG_COMPILED: dict = {}

_TREE_CHUNK = 4096  # chunk rows so the point-batched tree peaks at ~8 MB


def _leaves_traced_lf(dom: PlonkEvalDomain, S: PlonkStructure) -> jnp.ndarray:
    """All gates evaluated over all rows, gate-major, zero-padded to 2^m —
    LIMB-FIRST (L, N) (the whole tree pipeline runs limb-first; see
    `fields.jfield_lf`).

    Reference `get_evaluate_witness_fn` order [gate0(rows), gate1(rows), ...]
    (with the row-index fix documented in the module docstring).  Traceable:
    call under jit."""
    from ..fields.jfield_lf import lf_for

    flf = lf_for(S.field)
    outs = dom.evaluate_lf(list(S.gates))  # list of (L, n)
    flat = jnp.concatenate(outs, axis=1) if outs else flf.zeros((0,))
    pad = count_of_evaluation_with_padding(S) - flat.shape[1]
    if pad:
        flat = jnp.concatenate([flat, flf.zeros((pad,))], axis=1)
    return flat


def _make_eval_dom(S, sel, fixed, challenges, W1s) -> PlonkEvalDomain:
    dom = PlonkEvalDomain.__new__(PlonkEvalDomain)
    dom.S = S
    dom.challenges = list(challenges)
    dom.W1s = list(W1s)
    dom.W2s = []
    dom._sel_override = sel
    dom._fixed_override = fixed
    return dom


def _pow_coeffs_lf(flf, w_lf: jnp.ndarray, h0: int, levels: int) -> jnp.ndarray:
    """coeff[i] = prod_h w[h0+h]^bit_h(i) for i < 2^levels, by doubling:
    coeff_{h+1} = [coeff_h | coeff_h * w_h].  w_lf: (L, t, m) -> (L, t, 2^levels).

    Contiguous concatenations only: this replaces the naive even/odd
    halving tree, whose stride-2 slicing of the minor axis reads memory
    with a stride at every level."""
    t = w_lf.shape[1]
    coeff = flf.ones((t, 1))
    for h in range(levels):
        wh = w_lf[:, :, h0 + h][:, :, None]
        coeff = jnp.concatenate([coeff, flf.mul(coeff, wh)], axis=-1)
    return coeff


def _pow_weighted_reduce_lf(flf, vals: jnp.ndarray, w_lf: jnp.ndarray) -> jnp.ndarray:
    """sum_i pow_i(w) * vals[i] for t weight vectors at once (the weighted
    binary-tree reduction of reference `poly/mod.rs`, evaluated as one
    coefficient-product + contiguous log-depth sum).

    vals: (L, N) leaves, N = 2^m; w_lf: (L, t, m).  Returns (L, t).
    Chunked so peak coefficient memory stays ~t * _TREE_CHUNK elements."""
    Lw, N = vals.shape
    m = max(N.bit_length() - 1, 0)
    C = min(_TREE_CHUNK, N)
    lc = max(C.bit_length() - 1, 0)
    if N <= C:
        coeff = _pow_coeffs_lf(flf, w_lf, 0, m)
        return flf.sum_reduce(flf.mul(vals[:, None], coeff), axis=1)
    coeff_lo = _pow_coeffs_lf(flf, w_lf, 0, lc)       # (L, t, C)
    coeff_hi = _pow_coeffs_lf(flf, w_lf, lc, m - lc)  # (L, t, N/C)
    chunks = jnp.moveaxis(vals.reshape(Lw, N // C, C), 1, 0)  # (N/C, L, C)

    def body(carry, chunk):
        return carry, flf.sum_reduce(flf.mul(chunk[:, None], coeff_lo), axis=1)

    _, tops = jax.lax.scan(body, 0, chunks)  # (N/C, L, t)
    v = jnp.moveaxis(tops, 0, 2)  # (L, t, N/C)
    return flf.sum_reduce(flf.mul(v, coeff_hi), axis=1)


def _points_tree_fn(S: PlonkStructure, t: int):
    """(sel, fixed, challenges, W1s, weights (t,m,L)) -> (t, L) tree
    reductions of the shared gate-leaf array under t different weight sets.

    Split into TWO compiled programs (round-5 compile-wall fix): the heavy
    gate-leaf sweep `_leaves_fn` (one program per structure, shared between
    compute_F, compute_G and evaluate_e_from_trace regardless of t) and the
    cheap weighted tree reduce `_reduce_fn` (one tiny program per t).  The
    previous fused-per-t design compiled the full gate tape once per t value
    (t=1 for e, t=32 for F, again inside G) — 3 x ~20 s XLA compiles of
    near-identical mega-programs, the dominant cold-start cost."""
    leaves = _leaves_fn(S)
    red = _reduce_fn(S, t)

    def call(sel, fixed, challenges, W1s, weights):
        return red(leaves(sel, fixed, challenges, list(W1s)), weights)

    return call


def _leaves_fn(S: PlonkStructure):
    """Jitted gate-leaf sweep: (sel, fixed, challenges, W1s) -> (L, N)
    limb-first leaves.  The biggest XLA program in the PG pipeline; compiled
    ONCE per structure and shared by F/G/e."""
    key = ("leaves", id(S))
    fn = _PG_COMPILED.get(key)
    if fn is None:

        def run(sel, fixed, challenges, W1s):
            dom = _make_eval_dom(S, sel, fixed, challenges, W1s)
            return _leaves_traced_lf(dom, S)

        run.__name__ = f"pg_leaves_k{getattr(S, 'k', '?')}"
        fn = jax.jit(run)
        _PG_COMPILED[key] = fn
    return fn


def _reduce_fn(S: PlonkStructure, t: int):
    """Jitted weighted tree reduce: (vals_lf (L,N), weights (t,m,L)) ->
    (t, L) limb-last.  Small program (coefficient products + log-depth sum)."""
    N = count_of_evaluation_with_padding(S)
    key = ("reduce", S.field.spec.name, t, N)
    fn = _PG_COMPILED.get(key)
    if fn is None:
        from ..fields.jfield_lf import from_lf, lf_for

        flf = lf_for(S.field)

        def run(vals_lf, weights):
            w_lf = jnp.moveaxis(weights, -1, 0)  # (L, t, m)
            return from_lf(_pow_weighted_reduce_lf(flf, vals_lf, w_lf))

        run.__name__ = f"pg_reduce_t{t}_N{N}"
        fn = jax.jit(run)
        _PG_COMPILED[key] = fn
    return fn


def _weights_device(f, weight_ints: Sequence[Sequence[int]]) -> jnp.ndarray:
    """(t, m) host ints -> (t, m, L) Montgomery device array in one encode."""
    t = len(weight_ints)
    m = len(weight_ints[0])
    flat = [w % f.p for row in weight_ints for w in row]
    return f.encode(flat).reshape(t, m, -1)


def evaluate_e_from_trace(S: PlonkStructure, trace: PlonkTrace, betas: Sequence[int]) -> int:
    """Reference `evaluate_e_from_trace` (`nifs/protogalaxy/mod.rs:571-640`)."""
    if count_of_evaluation(S) == 0:
        return 0
    f = S.field
    weights = _weights_device(f, [list(betas)])
    challenges = [f.encode([c % f.p])[0] for c in trace.u.challenges]
    pts = _points_tree_fn(S, 1)(
        S.selectors_jax,
        S.fixed_jax,
        challenges,
        list(trace.w.W),
        weights,
    )
    return f.decode_one(pts[0])


# ---------------------------------------------------------------------------
# F / G / K polynomials
# ---------------------------------------------------------------------------


def compute_F(ctx: PolyContext, betas: Sequence[int], delta: int, trace: PlonkTrace) -> UnivariatePoly:
    """F(X) = sum_i pow_i(beta + X*delta_sq) f_i (reference `poly/mod.rs:68-203`).

    deltas[h] = delta^(2^h); edge weight at level h for point X:
    beta[h] + X * deltas[h]."""
    S = ctx.S
    spec = S.spec
    p = spec.modulus
    if count_of_evaluation(S) == 0:
        return UnivariatePoly(spec, [])
    f = S.field
    t = ctx.fft_points_count_F
    m = ctx.betas_count

    deltas = []
    d = delta % p
    for _ in range(m):
        deltas.append(d)
        d = d * d % p

    weight_ints = [
        [(betas[h] + X * deltas[h]) % p for h in range(m)]
        for X in lagrange.iter_cyclic_subgroup(spec, t.bit_length() - 1)
    ]
    challenges = [f.encode([c % p])[0] for c in trace.u.challenges]
    pts = _points_tree_fn(S, t)(
        S.selectors_jax,
        S.fixed_jax,
        challenges,
        list(trace.w.W),
        _weights_device(f, weight_ints),
    )
    points = f.decode(pts)
    return UnivariatePoly(spec, gold.fft(points, spec, inverse=True))


def _fold_w_fn(f, J: int, nrounds: int):
    """Cached jitted witness axpy: (l_dev (J,L), W_stacked per-round
    (J,size,L)) -> folded per-round (size,L)."""
    key = ("foldW", f.spec.name, J, nrounds)
    fn = _PG_COMPILED.get(key)
    if fn is None:
        from ..fields.jfield_lf import from_lf, lf_for

        flf = lf_for(f)

        def run(l_dev, W_stacked):
            ls_lf = jnp.moveaxis(l_dev, -1, 0)  # (L, J)
            return [
                from_lf(
                    flf.sum_reduce(
                        flf.mul(ls_lf[:, :, None], jnp.moveaxis(w_r, -1, 0)), axis=0
                    )
                )
                for w_r in W_stacked
            ]

        run.__name__ = "pg_fold_witness"
        fn = jax.jit(run)
        _PG_COMPILED[key] = fn
    return fn


def fold_witness_device(field, witnesses: Sequence[PlonkWitness], ls: Sequence[int]) -> PlonkWitness:
    """sum_j L_j * w_j over device round arrays (one jitted axpy program)."""
    f = field
    fn = _fold_w_fn(f, len(witnesses), len(witnesses[0].W))
    l_dev = f.encode([l % f.p for l in ls])  # (J, L)
    W_stacked = [
        jnp.stack([w.W[rnd] for w in witnesses]) for rnd in range(len(witnesses[0].W))
    ]
    return PlonkWitness(fn(l_dev, W_stacked))


def compute_G(
    ctx: PolyContext,
    betas_stroke: Sequence[int],
    accumulator: PlonkTrace,
    traces: Sequence[PlonkTrace],
) -> UnivariatePoly:
    """G(X) = sum_i pow_i(beta') f_i(sum_j L_j(X) w_j)
    (reference `poly/mod.rs:308-425`).

    Host loop over the FFT points, each iteration three SHARED compiled
    programs (witness axpy, gate-leaf sweep, t=1 tree reduce) — no
    G-specific XLA program at all (round-5 compile-wall fix).  Dispatch is
    async, so the loop pipelines on device; peak memory stays one point's
    folded witness, as with the previous lax.map design."""
    S = ctx.S
    spec = S.spec
    p = spec.modulus
    f = S.field
    weights = _weights_device(f, [list(betas_stroke)])  # (1, m, L)

    all_traces = [accumulator, *traces]
    J1 = len(all_traces)
    nch = S.num_challenges
    W_stacked = [
        jnp.stack([t.w.W[rnd] for t in all_traces])
        for rnd in range(len(accumulator.w.W))
    ]
    sel = S.selectors_jax
    fixed = S.fixed_jax
    fold = _fold_w_fn(f, J1, len(W_stacked))
    leaves = _leaves_fn(S)
    red = _reduce_fn(S, 1)

    pts = []
    for X in lagrange.iter_cyclic_subgroup(spec, ctx.fft_points_count_G.bit_length() - 1):
        ls = list(
            lagrange.iter_eval_lagrange_poly_for_cyclic_group(spec, X, ctx.lagrange_domain)
        )
        l_dev = f.encode([l % p for l in ls])  # (J1, L)
        ch_ints = [
            sum(l * (t.u.challenges[ci] if ci < len(t.u.challenges) else 0) for l, t in zip(ls, all_traces)) % p
            for ci in range(nch)
        ]
        challenges = [f.encode([c])[0] for c in ch_ints]
        W_folded = fold(l_dev, W_stacked)
        pts.append(red(leaves(sel, fixed, challenges, W_folded), weights)[0])
    points = f.decode(jnp.stack(pts))
    return UnivariatePoly(spec, gold.fft(points, spec, inverse=True))


def compute_K(
    ctx: PolyContext,
    poly_F_in_alpha: int,
    betas_stroke: Sequence[int],
    accumulator: PlonkTrace,
    traces: Sequence[PlonkTrace],
) -> UnivariatePoly:
    """K from G on a zeta-coset (reference `poly/mod.rs:464-509`)."""
    S = ctx.S
    spec = S.spec
    p = spec.modulus
    poly_G = compute_G(ctx, betas_stroke, accumulator, traces)

    log_k = ctx.fft_log_domain_size_K
    zeta = spec.zeta
    values = []
    for Xi in lagrange.iter_cyclic_subgroup(spec, log_k):
        X = zeta * Xi % p
        g_x = poly_G.eval(X)
        l0_x = next(
            iter(lagrange.iter_eval_lagrange_poly_for_cyclic_group(spec, X, ctx.lagrange_domain))
        )
        z_x = lagrange.eval_vanish_polynomial(spec, ctx.lagrange_domain, X)
        k_x = (g_x - poly_F_in_alpha * l0_x) * pow(z_x, -1, p) % p
        values.append(k_x)
    return UnivariatePoly(spec, gold.coset_ifft(values, spec))


def calculate_e(poly_F: UnivariatePoly, poly_K: UnivariatePoly, gamma: int, alpha: int, log_n: int) -> int:
    """e' = F(alpha)*L_0(gamma) + Z(gamma)*K(gamma)
    (reference `nifs/protogalaxy/mod.rs:748-764`)."""
    spec = poly_F.spec
    p = spec.modulus
    l0 = next(iter(lagrange.iter_eval_lagrange_poly_for_cyclic_group(spec, gamma, log_n)))
    return (
        poly_F.eval(alpha) * l0 + lagrange.eval_vanish_polynomial(spec, log_n, gamma) * poly_K.eval(gamma)
    ) % p


def betas_stroke_of(betas: Sequence[int], alpha: int, delta: int, p: int) -> list[int]:
    """beta'[i] = beta[i] + alpha * delta^(2^i) (reference `iter_beta_stroke`)."""
    out = []
    d = delta % p
    for b in betas:
        out.append((b + alpha * d) % p)
        d = d * d % p
    return out


# ---------------------------------------------------------------------------
# The scheme
# ---------------------------------------------------------------------------


class ProtoGalaxy:
    @staticmethod
    def setup_params(pp_digest_point, S: PlonkStructure):
        coords = (0, 0) if pp_digest_point.is_identity else (pp_digest_point.x, pp_digest_point.y)
        return ProverParam(S, coords), ProverParam(S, coords)

    @staticmethod
    def generate_plonk_trace(ck, instances, witness, pp: ProverParam, ro_nark: PoseidonHash) -> PlonkTrace:
        return run_sps_protocol(pp.S, ck, instances, witness, ro_nark)

    @staticmethod
    def _delta(pp, ro_acc: PoseidonHash, acc_ins: AccumulatorInstance, instances, q: int) -> int:
        pp.absorb_into(ro_acc, q)
        acc_ins.absorb_into(ro_acc, q)
        for u in instances:
            absorb_instance(ro_acc, u, q)
        return ro_acc.squeeze(MAX_BITS) % q

    @staticmethod
    def new_accumulator(pp: ProverParam, ro_acc: PoseidonHash, plonk_trace: PlonkTrace, curve: CurveSpec) -> Accumulator:
        """Reference `new_accumulator` (`nifs/protogalaxy/mod.rs:144-174`):
        betas[i] = beta * 2^i (doubling chain), e from the trace."""
        S = pp.S
        q = S.spec.modulus
        count = count_of_evaluation_with_padding(S)
        acc = Accumulator(
            trace=PlonkTrace(
                PlonkInstance(
                    [gold.identity(curve)] * len(S.round_sizes),
                    [[0] * io for io in S.num_io],
                    [0] * S.num_challenges,
                ),
                PlonkWitness.zeros(S.field, S.round_sizes),
            ),
            betas=[0] * (count.bit_length() - 1),
            e=0,
        )
        beta = ProtoGalaxy._delta(pp, ro_acc, AccumulatorInstance.from_acc(acc), [], q)
        b = beta
        for i in range(len(acc.betas)):
            acc.betas[i] = b
            b = b * 2 % q
        acc.e = evaluate_e_from_trace(S, plonk_trace, acc.betas)
        acc.trace = plonk_trace
        return acc

    @staticmethod
    def fold_instance(acc_u: PlonkInstance, incoming: Sequence[PlonkInstance], ls: Sequence[int], q: int) -> PlonkInstance:
        l0 = ls[0]
        W = [w.mul(l0) for w in acc_u.W_commitments]
        instances = [[v * l0 % q for v in inst] for inst in acc_u.instances]
        challenges = [c * l0 % q for c in acc_u.challenges]
        for u, l in zip(incoming, ls[1:]):
            W = [a.add(b.mul(l)) for a, b in zip(W, u.W_commitments)]
            instances = [
                [(av + l * bv) % q for av, bv in zip(ai, bi)]
                for ai, bi in zip(instances, u.instances)
            ]
            challenges = [(a + l * b) % q for a, b in zip(challenges, u.challenges)]
        return PlonkInstance(W, instances, challenges)

    @staticmethod
    def fold_witness(field, acc_w: PlonkWitness, incoming: Sequence[PlonkWitness], ls: Sequence[int]) -> PlonkWitness:
        return fold_witness_device(field, [acc_w, *incoming], ls)

    @staticmethod
    def prove(
        ck,
        pp: ProverParam,
        ro_acc: PoseidonHash,
        accumulator: Accumulator,
        incoming: Sequence[PlonkTrace],
    ) -> tuple[Accumulator, Proof]:
        """Reference `prove` (`nifs/protogalaxy/mod.rs:400-481`)."""
        S = pp.S
        q = S.spec.modulus
        L = len(incoming)
        ctx = PolyContext(S, L)

        delta = ProtoGalaxy._delta(
            pp, ro_acc, AccumulatorInstance.from_acc(accumulator), [t.u for t in incoming], q
        )
        from ..util.profiling import span

        with span("compute_F"):
            poly_F = compute_F(ctx, accumulator.betas, delta, accumulator.trace)
        for c in poly_F.coeffs:
            ro_acc.absorb_field(c % q)
        alpha = ro_acc.squeeze(MAX_BITS) % q

        b_stroke = betas_stroke_of(accumulator.betas, alpha, delta, q)
        with span("compute_K"):
            poly_K = compute_K(ctx, poly_F.eval(alpha), b_stroke, accumulator.trace, incoming)
        for c in poly_K.coeffs:
            ro_acc.absorb_field(c % q)
        gamma = ro_acc.squeeze(MAX_BITS) % q

        ls = list(lagrange.iter_eval_lagrange_poly_for_cyclic_group(S.spec, gamma, ctx.lagrange_domain))[: L + 1]

        with span("fold_trace"):
            new_acc = Accumulator(
                trace=PlonkTrace(
                    ProtoGalaxy.fold_instance(accumulator.trace.u, [t.u for t in incoming], ls, q),
                    ProtoGalaxy.fold_witness(S.field, accumulator.trace.w, [t.w for t in incoming], ls),
                ),
                betas=b_stroke,
                e=calculate_e(poly_F, poly_K, gamma, alpha, ctx.lagrange_domain),
            )
        return new_acc, Proof(poly_F, poly_K)

    @staticmethod
    def verify(
        vp,
        S_spec,
        ro_nark: PoseidonHash,
        ro_acc: PoseidonHash,
        accumulator: AccumulatorInstance,
        incoming: Sequence[PlonkInstance],
        proof: Proof,
    ) -> AccumulatorInstance:
        """Reference `verify` (`nifs/protogalaxy/mod.rs:510-553`)."""
        q = S_spec.modulus
        L = len(incoming)
        lagrange_domain = (L + 1).bit_length() - 1

        for u in incoming:
            sps_verify(u, ro_nark)

        vp.absorb_into(ro_acc, q)
        accumulator.absorb_into(ro_acc, q)
        for u in incoming:
            absorb_instance(ro_acc, u, q)
        delta = ro_acc.squeeze(MAX_BITS) % q
        for c in proof.poly_F.coeffs:
            ro_acc.absorb_field(c % q)
        alpha = ro_acc.squeeze(MAX_BITS) % q
        for c in proof.poly_K.coeffs:
            ro_acc.absorb_field(c % q)
        gamma = ro_acc.squeeze(MAX_BITS) % q

        b_stroke = betas_stroke_of(accumulator.betas, alpha, delta, q)
        ls = list(lagrange.iter_eval_lagrange_poly_for_cyclic_group(S_spec, gamma, lagrange_domain))
        return AccumulatorInstance(
            ins=ProtoGalaxy.fold_instance(accumulator.ins, incoming, ls, q),
            betas=b_stroke,
            e=calculate_e(proof.poly_F, proof.poly_K, gamma, alpha, lagrange_domain),
        )

    # -- satisfaction (reference `nifs/protogalaxy/mod.rs:642-745`) ------------
    @staticmethod
    def is_sat_accumulation(S: PlonkStructure, acc: Accumulator) -> None:
        evaluated = evaluate_e_from_trace(S, acc.trace, acc.betas)
        if evaluated != acc.e % S.spec.modulus:
            raise VerifyError(f"e mismatch: {hex(acc.e)} vs evaluated {hex(evaluated)}")

    @staticmethod
    def is_sat_permutation(S: PlonkStructure, acc: Accumulator) -> None:
        from ..plonk.permutation import device_perm_mismatches, perm_index_vector

        f = S.field
        head = [v for inst in acc.trace.u.instances for v in inst]
        total = head_len = len(head)
        total += S.n * S.num_advice_columns
        idx = perm_index_vector((id(S), "full"), S.permutation_matrix, total)
        mism = device_perm_mismatches(
            f, idx, head, acc.trace.w.W[0][: S.n * S.num_advice_columns]
        )
        if mism:
            raise VerifyError(f"permutation mismatch on {mism} entries")

    @staticmethod
    def is_sat_witness_commit(ck: CommitmentKey, acc: Accumulator) -> None:
        check = getattr(ck, "batched_commit_check", None)
        pairs = list(zip(acc.trace.w.W, acc.trace.u.W_commitments))
        if check is not None:
            bad = check(pairs)
            if bad:
                raise VerifyError(f"witness commitment mismatch rounds {bad}")
            return
        for i, (Wi, Ci) in enumerate(pairs):
            if ck.commit_device(Wi) != Ci:
                raise VerifyError(f"witness commitment mismatch round {i}")

    @staticmethod
    def is_sat(ck, S: PlonkStructure, acc: Accumulator, check_commit: bool = True) -> list:
        from ..util.profiling import span

        errors = []
        checks = [
            ("pg_is_sat_accumulation", lambda: ProtoGalaxy.is_sat_accumulation(S, acc)),
            ("pg_is_sat_permutation", lambda: ProtoGalaxy.is_sat_permutation(S, acc)),
        ]
        if check_commit:
            checks.append(
                ("pg_is_sat_witness_commit", lambda: ProtoGalaxy.is_sat_witness_commit(ck, acc))
            )
        for name, check in checks:
            try:
                with span(name):
                    check()
            except VerifyError as e:
                errors.append(e)
        return errors
