"""Evaluation domains: resolve expression queries to device column arrays.

Replaces reference `src/plonk/eval.rs` (SURVEY.md §2.3).  The reference
resolves (round, slot) per row at interpretation time; here the mapping is
baked at trace time into static slices of the round witness arrays, and the
whole expression evaluates row-parallel.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import jax.numpy as jnp

from ..poly.evaluator import evaluate_expressions, rotate_rows
from ..poly.expression import Expression, Query
from .structure import PlonkStructure

# compiled-evaluator cache: (structure id, expr ids, shapes) -> jitted fn
_COMPILED_CACHE: dict = {}


def witness_index_map(num_advice: int, num_witness: int, index: int) -> tuple[int, int]:
    """Folded-variable index -> (round, slot) (reference `eval.rs:93-229`).

    index < num_advice -> advice slot in round 0; lookup vars (l,t,m | h,g)
    land per the round layout decided by the SPS round count.
    """
    if index < num_advice:
        return (0, index)
    lookup_index = (index - num_advice) // 5
    sub = (index - num_advice) % 5
    first_round, sub = (True, sub) if sub < 3 else (False, sub - 3)
    if num_witness == 2:
        if first_round:
            return (0, num_advice + lookup_index * 3 + sub)
        return (1, lookup_index * 2 + sub)
    if num_witness == 3:
        if first_round:
            return (1, lookup_index * 3 + sub)
        return (2, lookup_index * 2 + sub)
    raise ValueError(f"invalid witness index {index} for {num_witness} rounds")


@dataclass
class PlonkEvalDomain:
    """Two witness sets (accumulator + incoming) for cross-term evaluation;
    W2s empty for plain satisfaction checks."""

    S: PlonkStructure
    challenges: list  # list of (L,) Montgomery device scalars
    W1s: list  # list of (round_size, L) device arrays
    W2s: list

    def resolve_challenge(self, index: int):
        return self.challenges[index]

    def resolve_poly(self, q: Query):
        S = self.S
        n = S.n
        idx = q.index
        num_sel = S.selectors.shape[0]
        num_fixed = len(S.fixed_columns)
        sel = getattr(self, "_sel_override", None)
        fixed = getattr(self, "_fixed_override", None)
        if idx < num_sel:
            col = (sel if sel is not None else S.selectors_device)[idx]
        elif idx < num_sel + num_fixed:
            col = (fixed if fixed is not None else S.fixed_device)[idx - num_sel]
        else:
            fold_idx = idx - num_sel - num_fixed
            max_width = S.num_fold_vars()
            if fold_idx < max_width:
                Ws, local = self.W1s, fold_idx
            else:
                Ws, local = self.W2s, fold_idx - max_width
            rnd, slot = witness_index_map(S.num_advice_columns, len(Ws), local)
            col = Ws[rnd][slot * n : (slot + 1) * n]
        return rotate_rows(col, q.rotation)

    def evaluate_lf(self, exprs: Sequence[Expression]) -> list:
        """Trace exprs into LIMB-FIRST (L, n) Montgomery arrays.

        Every source column transposes to (L, n) once and all field ops run
        limb-first, with rows on the contiguous axis (see
        `fields.jfield_lf`)."""
        from ..fields.jfield_lf import lf_for, to_lf

        flf = lf_for(self.S.field)
        S = self.S
        n = S.n
        num_sel = S.selectors.shape[0]
        num_fixed = len(S.fixed_columns)
        sel = getattr(self, "_sel_override", None)
        fixed = getattr(self, "_fixed_override", None)
        sel = jnp.asarray(sel if sel is not None else S.selectors_device)
        fixed = jnp.asarray(fixed if fixed is not None else S.fixed_device)
        # one transpose per source container
        sel_lf = jnp.swapaxes(sel, 1, 2) if sel.shape[0] else sel.reshape(0, 0, 0)
        fixed_lf = jnp.swapaxes(fixed, 1, 2) if fixed.shape[0] else fixed.reshape(0, 0, 0)
        # callers with already-limb-first witnesses (e.g. the PG G-point
        # fold) can set _lf_W1s to skip the transpose
        W1_lf = getattr(self, "_lf_W1s", None)
        if W1_lf is None:
            W1_lf = [to_lf(w) for w in self.W1s]
        W2_lf = [to_lf(w) for w in self.W2s]

        def resolve_lf(q: Query):
            idx = q.index
            if idx < num_sel:
                col = sel_lf[idx]
            elif idx < num_sel + num_fixed:
                col = fixed_lf[idx - num_sel]
            else:
                fold_idx = idx - num_sel - num_fixed
                max_width = S.num_fold_vars()
                if fold_idx < max_width:
                    Ws, local = W1_lf, fold_idx
                else:
                    Ws, local = W2_lf, fold_idx - max_width
                rnd, slot = witness_index_map(S.num_advice_columns, len(Ws), local)
                col = Ws[rnd][:, slot * n : (slot + 1) * n]
            if q.rotation == 0:
                return col
            return jnp.roll(col, -q.rotation, axis=-1)

        def resolve_ch(i: int):
            return self.challenges[i]  # (L,) — identical in both layouts

        return evaluate_expressions(flf, exprs, resolve_lf, resolve_ch)

    def evaluate(self, exprs: Sequence[Expression]) -> list:
        """Trace exprs into (n, L) Montgomery arrays (jit at the call site);
        internally limb-first with one transpose per source/output."""
        from ..fields.jfield_lf import from_lf

        return [from_lf(o) for o in self.evaluate_lf(exprs)]

    def evaluate_compiled(self, exprs: Sequence[Expression]) -> list:
        """Jit-compiled evaluation with the structure columns and witnesses
        passed as ARGUMENTS (not baked constants — baking 2^k-row constants
        stalls XLA's constant folding).  Compiled fns are cached per
        (structure, expression-set)."""
        key = (id(self.S), tuple(id(e) for e in exprs), len(self.W1s), len(self.W2s), len(self.challenges))
        fn = _COMPILED_CACHE.get(key)
        if fn is None:
            S = self.S

            def run(sel, fixed, challenges, W1s, W2s):
                dom = PlonkEvalDomain.__new__(PlonkEvalDomain)
                dom.S = S
                dom.challenges = challenges
                dom.W1s = W1s
                dom.W2s = W2s
                dom._sel_override = sel
                dom._fixed_override = fixed
                return evaluate_expressions(
                    S.field, exprs, dom.resolve_poly, dom.resolve_challenge
                )

            import jax

            run.__name__ = f"gate_eval_k{getattr(S, 'k', '?')}_e{len(exprs)}"
            fn = jax.jit(run)
            _COMPILED_CACHE[key] = fn
        return fn(
            self.S.selectors_jax,
            self.S.fixed_jax,
            list(self.challenges),
            list(self.W1s),
            list(self.W2s),
        )
