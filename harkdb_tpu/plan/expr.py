"""Vectorized expression evaluation over columnar batches.

Expressions are *resolved* AST trees — every ``Col`` node's ``name`` is an
internal column key of the working batch (resolution happens in the planner).
Evaluation is pure ``jnp`` over whole columns: one fused elementwise pass
under jit, no per-row interpretation (the reference has no expression
engine at all — its WHERE support is a commented-out stub, ``select.fut:18``).

Semantics:
  * int ∘ int arithmetic stays int; `/` and `%` use C-style truncation
    (``lax.div``/``lax.rem``) like generated C would;
  * int division by zero does NOT trap (no exceptions inside jit): XLA
    defines ``x / 0 == -1`` and ``x % 0 == x`` — pinned in
    tests/test_features.py (float division by zero yields ±inf/nan per
    IEEE as usual);
  * int ∘ float promotes to the engine float dtype;
  * comparisons yield bool; and/or/not operate on bool.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from harkdb_tpu.config import DEFAULT_CONFIG, EngineConfig
from harkdb_tpu.sql.ast_nodes import Agg, BinOp, Case, Col, Lit, LutMember, UnOp

Array = jax.Array


class ExprError(Exception):
    pass


def _promote(a, b):
    if jnp.issubdtype(a.dtype, jnp.floating) or jnp.issubdtype(b.dtype, jnp.floating):
        tgt = a.dtype if jnp.issubdtype(a.dtype, jnp.floating) else b.dtype
        return a.astype(tgt), b.astype(tgt)
    return a, b


def eval_expr(expr, columns: Dict[str, Array], capacity: int,
              config: EngineConfig = DEFAULT_CONFIG) -> Array:
    """Evaluate a resolved expression to a column of shape (capacity,)."""
    if isinstance(expr, Lit):
        if isinstance(expr.value, str):
            raise ExprError(
                "String literal reached the evaluator unlowered — the "
                "planner translates string comparisons to dictionary codes"
            )
        if isinstance(expr.value, float):
            return jnp.full((capacity,), expr.value,
                            jnp.dtype(config.float_dtype))
        return jnp.full((capacity,), expr.value, jnp.dtype(config.int_dtype))
    if isinstance(expr, LutMember):
        codes = eval_expr(expr.col, columns, capacity, config)
        lut = jnp.asarray(expr.lut, dtype=jnp.bool_)
        # Codes of live rows are valid dictionary indices; padding rows may
        # hold anything, so clamp (their result is masked downstream anyway).
        idx = jnp.clip(codes, 0, lut.shape[0] - 1).astype(jnp.int32)
        return lut[idx]
    from harkdb_tpu.sql.ast_nodes import CodeMap

    if isinstance(expr, CodeMap):
        # plan-time dictionary transform (UPPER/SUBSTR/LENGTH/...): one
        # small-LUT gather — row data never sees a string operation
        codes = eval_expr(expr.col, columns, capacity, config)
        lut = jnp.asarray(expr.lut)
        idx = jnp.clip(codes, 0, lut.shape[0] - 1).astype(jnp.int32)
        return lut[idx]
    if isinstance(expr, Col):
        try:
            return columns[expr.name]
        except KeyError:
            raise ExprError(f"Unresolved column {expr.name!r}") from None
    if isinstance(expr, UnOp):
        v = eval_expr(expr.operand, columns, capacity, config)
        if expr.op == "-":
            return -v
        if expr.op == "not":
            return jnp.logical_not(v.astype(jnp.bool_))
        if expr.op == "abs":
            return jnp.abs(v)
        if expr.op in ("floor", "ceil", "round"):
            # SQL numeric semantics: identity on integers; floats stay float
            # (values may exceed int32 range).
            if jnp.issubdtype(v.dtype, jnp.floating):
                if expr.op == "round":
                    # SQL ROUND is half-away-from-zero (round(2.5) = 3,
                    # round(-2.5) = -3); jnp.round is banker's rounding.
                    return jnp.sign(v) * jnp.floor(jnp.abs(v) + 0.5)
                f = {"floor": jnp.floor, "ceil": jnp.ceil}[expr.op]
                return f(v)
            return v
        if expr.op == "sqrt":
            return jnp.sqrt(v.astype(jnp.dtype(config.float_dtype)))
        if expr.op == "cast_int":
            # SQL CAST truncates toward zero (numpy/XLA float→int does too)
            return v.astype(jnp.dtype(config.int_dtype))
        if expr.op == "cast_float":
            return v.astype(jnp.dtype(config.float_dtype))
        raise ExprError(f"Unknown unary op {expr.op!r}")
    if isinstance(expr, Case):
        # First true WHEN wins: fold jnp.where back-to-front over a chain of
        # selects (one fused elementwise pass). Missing ELSE yields 0 (no NULLs).
        results = [eval_expr(r, columns, capacity, config)
                   for _c, r in expr.whens]
        out = (eval_expr(expr.else_, columns, capacity, config)
               if expr.else_ is not None
               else jnp.zeros((capacity,), results[0].dtype))
        for (cond, _r), res in zip(reversed(expr.whens), reversed(results)):
            c = eval_expr(cond, columns, capacity, config).astype(jnp.bool_)
            res, out = _promote(res, out)
            out = jnp.where(c, res, out)
        return out
    if isinstance(expr, BinOp):
        a = eval_expr(expr.left, columns, capacity, config)
        b = eval_expr(expr.right, columns, capacity, config)
        op = expr.op
        if op in ("and", "or"):
            a = a.astype(jnp.bool_)
            b = b.astype(jnp.bool_)
            return jnp.logical_and(a, b) if op == "and" else jnp.logical_or(a, b)
        a, b = _promote(a, b)
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            if jnp.issubdtype(a.dtype, jnp.floating):
                return a / b
            return jax.lax.div(a, b)          # C-style trunc toward zero
        if op == "%":
            if jnp.issubdtype(a.dtype, jnp.floating):
                return jnp.fmod(a, b)
            return jax.lax.rem(a, b)
        if op == "=":
            return a == b
        if op == "!=":
            return a != b
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
        raise ExprError(f"Unknown operator {op!r}")
    if isinstance(expr, Agg):
        raise ExprError(
            "Aggregate reached the evaluator unrewritten — planner bug"
        )
    from harkdb_tpu.sql.ast_nodes import InSub, NullTag, SubQuery

    if isinstance(expr, NullTag):
        # nullability marker only — the value is the wrapped expression
        return eval_expr(expr.expr, columns, capacity, config)
    if isinstance(expr, (SubQuery, InSub)):
        raise ExprError(
            "Subquery reached the evaluator unresolved — planner bug "
            "(_resolve_subqueries substitutes literals at first execution)"
        )
    raise ExprError(f"Cannot evaluate node {expr!r}")
