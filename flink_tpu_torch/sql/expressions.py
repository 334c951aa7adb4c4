"""Vectorized SQL expression compiler.

The reference code-generates Java source for every expression and aggregate
handler and compiles it with Janino at plan time
(``flink-table-planner-blink/.../codegen/``, ``ExprCodeGenerator`` et al.) —
"make the inner loop native".  The analog here compiles each expression tree
into a **columnar closure** ``fn(cols) -> array`` built from numpy ops: the
whole batch is evaluated in one vectorized call on the host, as in the JAX
package, and the device operators downstream take the columns it returns.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np

from flink_tpu_torch.sql.parser import (Between, Binary, Call, Case, Cast,
                                        Column, Expr, InList, Interval, IsNull,
                                        Like, Literal, SqlParseError, Star,
                                        Unary)

ColumnFn = Callable[[Mapping[str, Any]], Any]


class PlanError(ValueError):
    pass


def _is_int(a) -> bool:
    return getattr(np.asarray(a), "dtype", np.dtype(object)).kind in "iu"


def _sql_div(a, b):
    """SQL/Java integer division truncates toward zero; float division
    otherwise (Calcite semantics)."""
    if _is_int(a) and _is_int(b):
        a = np.asarray(a)
        b = np.asarray(b)
        q = np.floor_divide(a, b)
        # floor_divide rounds toward -inf; Java truncates toward zero, so
        # bump by one when operand signs differ and division was inexact
        return np.where((q * b != a) & ((a < 0) != (b < 0)), q + 1, q)
    return np.asarray(a, np.float64) / np.asarray(b, np.float64)


def _sql_mod(a, b):
    """SQL/Java remainder: sign follows the dividend (np.mod follows the
    divisor — MOD(-7, 2) must be -1, not 1)."""
    r = np.fmod(a, b)
    if _is_int(a) and _is_int(b):
        return r.astype(np.result_type(a, b))
    return r


def _as_str(a) -> np.ndarray:
    arr = np.asarray(a)
    if arr.dtype.kind in "OU":
        return arr.astype(str)
    return arr.astype(str)


_TYPE_CASTS = {
    "TINYINT": np.int8, "SMALLINT": np.int16, "INT": np.int32,
    "INTEGER": np.int32, "BIGINT": np.int64, "FLOAT": np.float32,
    "REAL": np.float32, "DOUBLE": np.float64, "DECIMAL": np.float64,
    "NUMERIC": np.float64, "BOOLEAN": bool, "TIMESTAMP": np.int64,
    "DATE": np.int64,
}


def _cast(value, type_name: str):
    ty = type_name.upper()
    if ty in ("VARCHAR", "CHAR", "STRING"):
        return _as_str(value).astype(object)
    np_ty = _TYPE_CASTS.get(ty)
    if np_ty is None:
        raise PlanError(f"unsupported CAST target {type_name!r}")
    arr = np.asarray(value)
    if arr.dtype.kind in "OU":
        if np_ty is bool:
            # SQL string→boolean by literal value, not Python truthiness
            lowered = np.char.lower(arr.astype(str))
            truth = np.isin(lowered, ("true", "t", "1", "yes"))
            bad = ~truth & ~np.isin(lowered, ("false", "f", "0", "no", ""))
            if bad.any():
                raise PlanError(
                    f"cannot CAST {arr[bad][0]!r} to BOOLEAN")
            return truth
        arr = arr.astype(str).astype(np.float64)
    return arr.astype(np_ty)


# scalar function registry: NAME -> impl(*arg_arrays) -> array
SCALAR_FUNCS: Dict[str, Callable[..., Any]] = {
    "ABS": lambda x: np.abs(x),
    "CEIL": lambda x: np.ceil(x),
    "CEILING": lambda x: np.ceil(x),
    "FLOOR": lambda x: np.floor(x),
    "ROUND": lambda x, d=None: np.round(x, int(d) if d is not None else 0),
    "SQRT": lambda x: np.sqrt(np.asarray(x, np.float64)),
    "EXP": lambda x: np.exp(np.asarray(x, np.float64)),
    "LN": lambda x: np.log(np.asarray(x, np.float64)),
    "LOG10": lambda x: np.log10(np.asarray(x, np.float64)),
    "POWER": lambda x, y: np.power(np.asarray(x, np.float64), y),
    # fmod = truncated modulo (sign of dividend), matching Java/Calcite %
    "MOD": lambda x, y: _sql_mod(x, y),
    "SIGN": lambda x: np.sign(x),
    "UPPER": lambda s: np.char.upper(_as_str(s)).astype(object),
    "LOWER": lambda s: np.char.lower(_as_str(s)).astype(object),
    "TRIM": lambda s: np.char.strip(_as_str(s)).astype(object),
    "LTRIM": lambda s: np.char.lstrip(_as_str(s)).astype(object),
    "RTRIM": lambda s: np.char.rstrip(_as_str(s)).astype(object),
    "CHAR_LENGTH": lambda s: np.char.str_len(_as_str(s)).astype(np.int32),
    "CHARACTER_LENGTH": lambda s: np.char.str_len(_as_str(s)).astype(np.int32),
    "LENGTH": lambda s: np.char.str_len(_as_str(s)).astype(np.int32),
    "CONCAT": lambda *ss: _concat(*ss),
    "COALESCE": lambda *xs: xs[0],  # engine has no NULLs; first arg wins
    "LEAST": lambda *xs: np.minimum.reduce([np.asarray(x) for x in xs]),
    "GREATEST": lambda *xs: np.maximum.reduce([np.asarray(x) for x in xs]),
    "IF": lambda c, a, b: np.where(np.asarray(c, bool), a, b),
}


def _concat(*ss):
    out = _as_str(ss[0])
    for s in ss[1:]:
        out = np.char.add(out, _as_str(s))
    return out.astype(object)


def _substring(s, start, length=None):
    strs = _as_str(s)
    start = np.asarray(start) - 1  # SQL is 1-based
    if length is None:
        return np.asarray(
            [x[int(st):] for x, st in np.broadcast(strs, start)], object)
    length = np.asarray(length)
    return np.asarray(
        [x[int(st):int(st) + int(ln)]
         for x, st, ln in np.broadcast(strs, start, length)], object)


SCALAR_FUNCS["SUBSTRING"] = _substring
SCALAR_FUNCS["SUBSTR"] = _substring


def _like_to_re(pattern: str) -> "re.Pattern":
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


class ExprCompiler:
    """Compiles parser AST into columnar closures.

    ``resolver`` maps a column name to a closure producing its array; the
    default reads ``cols[name]`` and raises on unknown names at plan time if
    a schema is supplied.
    """

    def __init__(self, schema: Optional[Mapping[str, Any]] = None,
                 resolver: Optional[Callable[[str], Optional[ColumnFn]]] = None):
        self.schema = schema
        self.resolver = resolver

    def compile(self, expr: Expr) -> ColumnFn:
        if isinstance(expr, Literal):
            v = expr.value
            if v is None:
                raise PlanError("NULL literals are not supported (no-NULL engine)")
            return lambda cols: v
        if isinstance(expr, Interval):
            ms = expr.ms
            return lambda cols: ms
        if isinstance(expr, Column):
            if self.resolver is not None:
                fn = self.resolver(expr.name)
                if fn is not None:
                    return fn
            name = expr.name
            if self.schema is not None and name not in self.schema:
                raise PlanError(f"unknown column {name!r}; have "
                                f"{sorted(self.schema)}")
            return lambda cols: cols[name]
        if isinstance(expr, Unary):
            f = self.compile(expr.operand)
            if expr.op == "-":
                return lambda cols: -np.asarray(f(cols))
            if expr.op == "NOT":
                return lambda cols: ~np.asarray(f(cols), bool)
            raise PlanError(f"unknown unary {expr.op}")
        if isinstance(expr, Binary):
            return self._compile_binary(expr)
        if isinstance(expr, Between):
            f = self.compile(expr.expr)
            lo = self.compile(expr.lo)
            hi = self.compile(expr.hi)

            def between(cols):
                v = f(cols)
                m = (v >= lo(cols)) & (v <= hi(cols))
                return ~m if expr.negated else m
            return between
        if isinstance(expr, InList):
            f = self.compile(expr.expr)
            items = [self.compile(i) for i in expr.items]

            def in_list(cols):
                v = np.asarray(f(cols))
                m = np.zeros(v.shape, bool)
                for it in items:
                    m |= np.asarray(v == it(cols))
                return ~m if expr.negated else m
            return in_list
        if isinstance(expr, Like):
            f = self.compile(expr.expr)
            rx = _like_to_re(expr.pattern)

            def like(cols):
                vals = _as_str(f(cols))
                m = np.fromiter((rx.match(x) is not None for x in vals),
                                bool, count=len(vals))
                return ~m if expr.negated else m
            return like
        if isinstance(expr, IsNull):
            f = self.compile(expr.expr)
            negated = expr.negated

            def is_null(cols):
                v = np.asarray(f(cols))
                m = np.zeros(np.shape(v) or (1,), bool)
                return ~m if negated else m
            return is_null
        if isinstance(expr, Cast):
            f = self.compile(expr.expr)
            ty = expr.type_name
            return lambda cols: _cast(f(cols), ty)
        if isinstance(expr, Case):
            whens = [(self.compile(c), self.compile(r)) for c, r in expr.whens]
            default = self.compile(expr.default) if expr.default is not None else None

            def case(cols):
                conds = [np.asarray(c(cols), bool) for c, _ in whens]
                n = max((c.shape[0] for c in conds if c.ndim), default=1)
                if default is None:
                    # SQL default ELSE NULL; no-NULL engine zero-fills
                    first = np.asarray(whens[0][1](cols))
                    out = np.zeros(n, first.dtype if first.dtype.kind != "O" else object)
                else:
                    out = np.broadcast_to(np.asarray(default(cols)), (n,)).copy()
                # apply in reverse so the FIRST matching WHEN wins
                for cond, res in reversed(list(zip(conds, (r for _, r in whens)))):
                    out = np.where(cond, res(cols), out)
                return out
            return case
        if isinstance(expr, Call):
            return self._compile_call(expr)
        if isinstance(expr, Star):
            raise PlanError("* only valid directly in SELECT list")
        raise PlanError(f"cannot compile {expr!r}")

    def _compile_binary(self, expr: Binary) -> ColumnFn:
        lf = self.compile(expr.left)
        rf = self.compile(expr.right)
        op = expr.op
        if op == "AND":
            return lambda cols: np.asarray(lf(cols), bool) & np.asarray(rf(cols), bool)
        if op == "OR":
            return lambda cols: np.asarray(lf(cols), bool) | np.asarray(rf(cols), bool)
        if op == "||":
            return lambda cols: _concat(lf(cols), rf(cols))
        if op == "+":
            return lambda cols: np.add(lf(cols), rf(cols))
        if op == "-":
            return lambda cols: np.subtract(lf(cols), rf(cols))
        if op == "*":
            return lambda cols: np.multiply(lf(cols), rf(cols))
        if op == "/":
            return lambda cols: _sql_div(lf(cols), rf(cols))
        if op == "%":
            return lambda cols: _sql_mod(lf(cols), rf(cols))
        cmp = {"=": np.equal, "<>": np.not_equal, "<": np.less,
               "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}
        if op in cmp:
            f = cmp[op]
            return lambda cols: np.asarray(f(lf(cols), rf(cols)), bool)
        raise PlanError(f"unknown operator {op}")

    def _compile_call(self, expr: Call) -> ColumnFn:
        name = expr.name
        impl = SCALAR_FUNCS.get(name)
        if impl is None:
            raise PlanError(f"unknown function {name!r} (aggregates must be "
                            "split out by the planner before compiling)")
        arg_fns = [self.compile(a) for a in expr.args]
        return lambda cols: impl(*(f(cols) for f in arg_fns))


def expr_name(expr: Expr, i: int) -> str:
    """Derived output column name for an unaliased select item."""
    if isinstance(expr, Column):
        return expr.name
    if isinstance(expr, Call) and len(expr.args) == 1 and \
            isinstance(expr.args[0], Column):
        return f"{expr.name}_{expr.args[0].name}".lower()
    return f"EXPR${i}"


def to_column(value, n: int):
    """Broadcast a scalar compile result to a full column of length n."""
    arr = np.asarray(value)
    if arr.ndim == 0:
        if arr.dtype.kind in "OU":
            return np.full(n, arr.item(), object)
        return np.full(n, arr.item(), arr.dtype)
    return arr
