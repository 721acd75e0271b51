"""Expression -> jitted row-parallel evaluator.

Device replacement for reference `src/polynomial/graph_evaluator.rs`
(SURVEY.md §2.2): instead of interpreting an SSA tape per row, the AST is
traced once into an XLA program over whole column arrays; the per-row loop
disappears and XLA fuses the element-wise field ops.  Common subexpressions
are shared via structural memoization (the analogue of the reference's CSE).
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax.numpy as jnp

from ..fields.jfield import Field
from .expression import (
    Challenge,
    Constant,
    Expression,
    Neg,
    Poly,
    Product,
    Query,
    Scaled,
    Sum,
)


def evaluate_expressions(
    field: Field,
    exprs: Sequence[Expression],
    resolve_poly: Callable[[Query], jnp.ndarray],
    resolve_challenge: Callable[[int], jnp.ndarray],
) -> list[jnp.ndarray]:
    """Trace `exprs` into array programs.

    resolve_poly(query) must return the (rotated) column array (..., L) in
    Montgomery form; resolve_challenge(i) a (L,) Montgomery scalar.  Wrap the
    caller in jax.jit for compilation; this function is trace-time only.
    """
    f = field
    memo: dict[Expression, jnp.ndarray] = {}

    def go(e: Expression) -> jnp.ndarray:
        hit = memo.get(e)
        if hit is not None:
            return hit
        if isinstance(e, Constant):
            r = f.const(e.value % f.p)
        elif isinstance(e, Poly):
            r = resolve_poly(e.query)
        elif isinstance(e, Challenge):
            r = resolve_challenge(e.index)
        elif isinstance(e, Neg):
            r = f.neg(go(e.arg))
        elif isinstance(e, Sum):
            r = f.add(go(e.lhs), go(e.rhs))
        elif isinstance(e, Product):
            r = f.mul(go(e.lhs), go(e.rhs))
        elif isinstance(e, Scaled):
            r = f.mul(go(e.arg), f.const(e.scalar % f.p))
        else:
            raise TypeError(e)
        memo[e] = r
        return r

    return [go(e) for e in exprs]


def rotate_rows(col: jnp.ndarray, rotation: int) -> jnp.ndarray:
    """Cyclic rotation: out[i] = col[(i + rotation) mod n]
    (reference row indexing `(row + rot) & (n-1)`)."""
    if rotation == 0:
        return col
    return jnp.roll(col, -rotation, axis=0)
