"""Plonkish structure: the folding IR of a circuit.

Replaces reference `src/plonk/mod.rs` (SURVEY.md §2.3).  Host metadata holds
python ints; device mirrors (Montgomery limb arrays) are built lazily and
cached for the row-parallel kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..fields.constants import NUM_LIMBS, FieldSpec
from ..fields.jfield import Field, field_for
from ..poly.expression import Expression, QueryIndexContext, compress_expression
from ..poly.grouped import GroupedPoly


@dataclass
class CompressedGates:
    """compressed -> homogeneous -> (lazy) degree-grouped
    (reference `plonk/mod.rs:68-121`)."""

    compressed: Expression
    homogeneous: Expression
    homogeneous_degree: int
    ctx: QueryIndexContext
    _grouped: Optional[GroupedPoly] = None

    @staticmethod
    def new(original: Sequence[Expression], ctx: QueryIndexContext) -> "CompressedGates":
        compressed = compress_expression(list(original), ctx.num_challenges)
        ctx = ctx.with_challenges(compressed.num_challenges())
        hom = compressed.homogeneous(ctx)
        ctx = ctx.with_challenges(hom.expr.num_challenges())
        return CompressedGates(compressed, hom.expr, hom.degree, ctx)

    @property
    def grouped(self) -> GroupedPoly:
        if self._grouped is None:
            self._grouped = GroupedPoly.new(self.homogeneous, self.ctx)
        return self._grouped


@dataclass
class PlonkStructure:
    """Reference `plonk/mod.rs:127-157`."""

    spec: FieldSpec  # scalar field of the commitment curve
    k: int
    num_io: list[int]
    selectors: np.ndarray  # bool (num_selectors, 2^k)
    fixed_columns: list[list[int]]  # (num_fixed, 2^k) host ints
    num_advice_columns: int
    num_challenges: int
    round_sizes: list[int]
    custom_gates_lookup_compressed: CompressedGates
    gates: list[Expression]
    permutation_data: "PermutationData"
    lookup_arguments: Optional["LookupArguments"]

    # -- shape helpers (reference `plonk/mod.rs:270-300`) -----------------------
    @property
    def n(self) -> int:
        return 1 << self.k

    def num_lookups(self) -> int:
        return 0 if self.lookup_arguments is None else len(self.lookup_arguments.lookup_polys)

    def has_vector_lookup(self) -> bool:
        return bool(self.lookup_arguments and self.lookup_arguments.has_vector_lookup)

    def num_non_fold_vars(self) -> int:
        return len(self.fixed_columns) + self.selectors.shape[0]

    def num_fold_vars(self) -> int:
        return self.num_advice_columns + 5 * self.num_lookups()

    def get_degree_for_folding(self) -> int:
        return len(self.custom_gates_lookup_compressed.grouped)

    @property
    def query_index_ctx(self) -> QueryIndexContext:
        return QueryIndexContext(
            num_selectors=self.selectors.shape[0],
            num_fixed=len(self.fixed_columns),
            num_advice=self.num_advice_columns,
            num_challenges=self.num_challenges,
            num_lookups=self.num_lookups(),
        )

    # -- device mirrors ---------------------------------------------------------
    @cached_property
    def field(self) -> Field:
        return field_for(self.spec)

    @cached_property
    def selectors_jax(self):
        """Device-RESIDENT selectors (uploaded once).  Passing the numpy
        `selectors_device` into a jitted call would re-transfer ~100 MB per
        call at k=17."""
        import jax

        return jax.device_put(self.selectors_device)

    @cached_property
    def fixed_jax(self):
        """Device-resident fixed columns (see selectors_jax)."""
        import jax

        return jax.device_put(self.fixed_device)

    @cached_property
    def selectors_device(self) -> np.ndarray:
        """(num_selectors, n, L) Montgomery 0/1 arrays.  Kept as numpy so the
        cache never captures a tracer; jit traces embed them as constants."""
        from ..fields.limb import int_to_limbs

        if self.selectors.shape[0] == 0:
            return np.zeros((0, self.n, NUM_LIMBS), np.uint32)
        one = int_to_limbs(self.field.r_mod_p)
        out = np.zeros((self.selectors.shape[0], self.n, NUM_LIMBS), np.uint32)
        out[self.selectors] = one
        return out

    @cached_property
    def fixed_device(self) -> np.ndarray:
        """(num_fixed, n, L) Montgomery arrays (host numpy; see above)."""
        from ..fields.limb import ints_to_limbs

        f = self.field
        if not self.fixed_columns:
            return np.zeros((0, self.n, NUM_LIMBS), np.uint32)
        flat = [v * (1 << 256) % f.p for col in self.fixed_columns for v in col]
        return ints_to_limbs(flat).reshape(len(self.fixed_columns), self.n, NUM_LIMBS)

    def permutation_matrix(self):
        """COO permutation matrix P with P@Z = Z (reference
        `plonk/mod.rs:664`)."""
        return self.permutation_data.matrix(self.k, self.num_io, self.num_advice_columns)


@dataclass
class PlonkInstance:
    """Reference `plonk/mod.rs:160-173`; points are host gold affine."""

    W_commitments: list  # list[gold.AffinePoint]
    instances: list[list[int]]
    challenges: list[int]

    def absorb_into(self, ro) -> None:
        """Absorb order: W_commitments, instances, challenges
        (reference `plonk/mod.rs:263-273`)."""
        for c in self.W_commitments:
            ro.absorb_point(c)
        for inst in self.instances:
            for v in inst:
                ro.absorb_field(v)
        for ch in self.challenges:
            ro.absorb_field(ch)

    def clone(self) -> "PlonkInstance":
        return PlonkInstance(
            list(self.W_commitments),
            [list(i) for i in self.instances],
            list(self.challenges),
        )


@dataclass
class PlonkWitness:
    """Per-round witness vectors; device-resident standard layout is the
    column-major concatenation of padded columns (reference
    `concatenate_with_padding`).  W[i] is a (round_size, L) Montgomery array."""

    W: list[jnp.ndarray]

    @staticmethod
    def zeros(field: Field, round_sizes: Sequence[int]) -> "PlonkWitness":
        return PlonkWitness([field.zeros((sz,)) for sz in round_sizes])

    def clone(self) -> "PlonkWitness":
        return PlonkWitness(list(self.W))


@dataclass
class PlonkTrace:
    u: PlonkInstance
    w: PlonkWitness

    def clone(self) -> "PlonkTrace":
        return PlonkTrace(self.u.clone(), self.w.clone())


# imported at bottom to avoid cycles
from .permutation import PermutationData  # noqa: E402
from .lookup import LookupArguments  # noqa: E402
