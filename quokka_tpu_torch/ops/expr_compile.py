"""Lower expression ASTs onto DeviceBatch columns (PyTorch port of
``quokka_tpu/ops/expr_compile.py``).

Two lowerings of one semantics:

- ``evaluate`` / ``evaluate_predicate`` / ``evaluate_to_column``: plain torch
  tensor code, op by op, on whatever device the batch lives on.  It is the
  unfused path and the plain version of the fused kernels.
- ``TritonExpr``: a Triton source generator for the fused kernels (K1's
  predicate, K2's and K5's pre-expressions, K16's in-stage filters and
  maps).  It turns the subset the fused programs need -- columns,
  literals, date constants, ``+ - * /``, comparisons, ``and/or/not``,
  ``is null``, ``in (...)``, ``case when``, ``extract(year|month|day)``
  from a date, the aggregate null wrappers and prepass-bound masks -- into
  straight-line Triton code
  with the same null (three-valued) semantics as ``evaluate``.  A node
  outside the subset raises ``CompileError`` and the caller takes the
  unfused path.

String rules: predicates and transforms on strings run on the host over the
(small) dictionary once, then a gather by code applies them to all rows.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from quokka_tpu_torch.expression import (
    Agg,
    Alias,
    BinOp,
    Case,
    Cast,
    ColRef,
    DateLit,
    DtField,
    Expr,
    Func,
    InList,
    IntervalLit,
    IsNull,
    Literal,
    StrOp,
    UnaryOp,
)
from quokka_tpu_torch.ops.batch import (
    NULL_I32,
    DeviceBatch,
    NumCol,
    StrCol,
    StringDict,
    null_mask,
)


class CompileError(Exception):
    pass


# ---------------------------------------------------------------------------
# torch evaluator
# ---------------------------------------------------------------------------


def evaluate(e: Expr, batch: DeviceBatch):
    """Evaluate an expression against a batch -> NumCol / StrCol / scalar."""
    if isinstance(e, Alias):
        return evaluate(e.expr, batch)
    if isinstance(e, ColRef):
        if e.name not in batch.columns:
            raise CompileError(f"unknown column {e.name}; have {batch.names}")
        return batch.columns[e.name]
    if isinstance(e, Literal):
        return e.value
    if isinstance(e, DateLit):
        return _DateScalar(e.days)
    if isinstance(e, IntervalLit):
        return e
    if isinstance(e, BinOp):
        return _binop(e.op, evaluate(e.left, batch), evaluate(e.right, batch))
    if isinstance(e, UnaryOp):
        if e.op == "not":
            # push NOT into comparisons so SQL 3VL holds: NOT (x = 5) with x
            # null must be false, not ~false
            pushed = _negate_expr(e.operand)
            if pushed is not None:
                return evaluate(pushed, batch)
            res = ~_as_bool(evaluate(e.operand, batch))
            if isinstance(e.operand, StrOp):
                v = evaluate(e.operand.expr, batch)
                if isinstance(v, (NumCol, StrCol)):
                    res = res & ~null_mask(v)
            return NumCol(res, "b")
        v = evaluate(e.operand, batch)
        if e.op == "-":
            if isinstance(v, NumCol):
                return NumCol(-v.data, v.kind)
            return -v
        raise CompileError(e.op)
    if isinstance(e, Case):
        return _case(e, batch)
    if isinstance(e, InList):
        return _in_list(e, batch)
    if isinstance(e, IsNull):
        return _is_null(e, batch)
    if isinstance(e, StrOp):
        return _str_op(e, batch)
    if isinstance(e, DtField):
        return _dt_field(e, batch)
    if isinstance(e, Cast):
        return _cast(e, batch)
    if isinstance(e, Func):
        return _func(e, batch)
    if isinstance(e, Agg):
        raise CompileError("aggregate expression used in a scalar context")
    raise CompileError(f"cannot compile {type(e).__name__}")


def evaluate_predicate(e: Expr, batch: DeviceBatch) -> torch.Tensor:
    return _as_bool(evaluate(e, batch), batch)


def evaluate_to_column(e: Expr, batch: DeviceBatch):
    return value_to_column(evaluate(e, batch), batch)


def value_to_column(v, batch: DeviceBatch):
    if isinstance(v, (NumCol, StrCol)):
        return v
    n, dev = batch.padded_len, batch.valid.device
    if isinstance(v, _DateScalar):
        return NumCol(torch.full((n,), v.days, dtype=torch.int32, device=dev), "d")
    if isinstance(v, str):
        return StrCol(torch.zeros(n, dtype=torch.int32, device=dev),
                      StringDict(np.array([v], dtype=object)))
    if isinstance(v, bool):
        return NumCol(torch.full((n,), v, dtype=torch.bool, device=dev), "b")
    if isinstance(v, int):
        return NumCol(torch.full((n,), v, dtype=torch.int64, device=dev), "i")
    if isinstance(v, float):
        return NumCol(torch.full((n,), v, dtype=torch.float64, device=dev), "f")
    raise CompileError(f"cannot materialize {type(v)} as a column")


class _DateScalar:
    __slots__ = ("days",)

    def __init__(self, days: int):
        self.days = days


def _as_bool(v, batch: Optional[DeviceBatch] = None) -> torch.Tensor:
    if isinstance(v, NumCol):
        return v.data if v.data.dtype == torch.bool else v.data != 0
    if isinstance(v, bool):
        if batch is not None:
            return torch.full((batch.padded_len,), v, dtype=torch.bool,
                              device=batch.valid.device)
        return torch.tensor(v)
    raise CompileError(f"expected boolean, got {type(v)}")


def _numeric_data(v):
    if isinstance(v, NumCol):
        return v.data
    if isinstance(v, _DateScalar):
        return v.days
    if isinstance(v, (int, float, bool)):
        return v
    raise CompileError(f"expected numeric, got {type(v)}")


def _result_kind(a, b, op):
    ka = a.kind if isinstance(a, NumCol) else _scalar_kind(a)
    kb = b.kind if isinstance(b, NumCol) else _scalar_kind(b)
    if op == "/":
        return "f"
    if "d" in (ka, kb) and op in ("+", "-"):
        if ka == "d" and kb == "d":
            return "i"
        return "d"
    if "f" in (ka, kb):
        return "f"
    return "i"


def _scalar_kind(v):
    if isinstance(v, _DateScalar):
        return "d"
    if isinstance(v, bool):
        return "b"
    if isinstance(v, int):
        return "i"
    if isinstance(v, float):
        return "f"
    return "?"


_CMP = {"=", "!=", "<", "<=", ">", ">="}
_CMP_FN = {
    "=": lambda x, y: x == y,
    "!=": lambda x, y: x != y,
    "<": lambda x, y: x < y,
    "<=": lambda x, y: x <= y,
    ">": lambda x, y: x > y,
    ">=": lambda x, y: x >= y,
}


def _float_operands(da, db):
    """x64 promotion: an int tensor meeting a Python float is float64 (torch
    would otherwise pick its default float32)."""
    if isinstance(db, float) and torch.is_tensor(da) and not da.is_floating_point():
        da = da.to(torch.float64)
    if isinstance(da, float) and torch.is_tensor(db) and not db.is_floating_point():
        db = db.to(torch.float64)
    return da, db


def _binop(op, a, b):
    if op in ("and", "or"):
        xa, xb = _as_bool(a), _as_bool(b)
        return NumCol(xa & xb if op == "and" else xa | xb, "b")
    if isinstance(a, StrCol) or isinstance(b, StrCol):
        return _string_compare(op, a, b)
    if isinstance(b, IntervalLit):
        return _date_interval(op, a, b)
    if isinstance(a, IntervalLit):
        raise CompileError("interval must be on the right-hand side")
    da, db = _float_operands(_numeric_data(a), _numeric_data(b))
    if op in _CMP:
        res = _CMP_FN[op](da, db)
        if not torch.is_tensor(res):
            return bool(res)
        # SQL three-valued logic: a null operand makes the predicate false
        for side in (a, b):
            if isinstance(side, NumCol) and side.kind in ("i", "d", "t", "f"):
                res = res & ~null_mask(side)
        return NumCol(res, "b")
    kind = _result_kind(a, b, op)
    if op == "+":
        out = da + db
    elif op == "-":
        out = da - db
    elif op == "*":
        out = da * db
    elif op == "/":
        fa = da.to(torch.float64) if torch.is_tensor(da) else float(da)
        fb = db.to(torch.float64) if torch.is_tensor(db) else float(db)
        out = fa / fb
    elif op == "//":
        out = da // db
    elif op == "%":
        out = da % db
    else:
        raise CompileError(f"binop {op}")
    if not torch.is_tensor(out):
        return out
    # arithmetic would destroy int sentinels: re-mark the result null where
    # a sentinel-kind operand was null
    nulls = None
    for side in (a, b):
        if isinstance(side, NumCol) and side.kind in ("i", "d", "t"):
            nm = null_mask(side)
            nulls = nm if nulls is None else nulls | nm
    if nulls is not None:
        if kind == "f" or out.is_floating_point():
            out = torch.where(nulls, torch.full((), float("nan"), dtype=out.dtype,
                                                device=out.device)
                              if out.is_floating_point() else float("nan"), out)
        else:
            out = torch.where(nulls, torch.full((), torch.iinfo(out.dtype).min,
                                                dtype=out.dtype, device=out.device), out)
    return NumCol(out, kind)


def _add_months_scalar(days: int, delta_months: int) -> int:
    import calendar
    import datetime

    dt = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))
    mt = dt.year * 12 + (dt.month - 1) + int(delta_months)
    y2, m2 = mt // 12, mt % 12 + 1
    d2 = min(dt.day, calendar.monthrange(y2, m2)[1])
    return (datetime.date(y2, m2, d2) - datetime.date(1970, 1, 1)).days


def _days_in_month(y, m):
    lengths = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                           dtype=y.dtype, device=y.device)
    leap = ((y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0))).to(y.dtype)
    return lengths[(m - 1).long()] + torch.where(m == 2, leap, torch.zeros_like(leap))


def _date_interval(op, a, iv: IntervalLit):
    if iv.months:
        delta_m = -iv.months if op == "-" else iv.months
        if iv.micros:
            raise CompileError("mixed month+day intervals")
        if isinstance(a, _DateScalar):
            return _DateScalar(_add_months_scalar(a.days, delta_m))
        if isinstance(a, NumCol) and a.kind == "d":
            y, m, d = _civil_from_days(a.data.to(torch.int64))
            mt = y * 12 + (m - 1) + delta_m
            y2 = torch.div(mt, 12, rounding_mode="floor")
            m2 = mt - y2 * 12 + 1
            d2 = torch.minimum(d, _days_in_month(y2, m2))
            out = _days_from_civil(y2, m2, d2)
            return NumCol(torch.where(null_mask(a), torch.full_like(out, NULL_I32), out), "d")
        raise CompileError("month/year interval arithmetic on non-date")
    if not isinstance(a, NumCol):
        if isinstance(a, _DateScalar):
            return _DateScalar(a.days + (iv.days if op == "+" else -iv.days))
        raise CompileError("interval arithmetic on non-date")
    if a.kind == "d":
        delta = iv.days
    elif a.kind == "t":
        scale = {"s": 1_000_000, "ms": 1_000, "us": 1, "ns": 1 / 1000}[a.unit or "us"]
        delta = int(iv.micros / scale)
    else:
        raise CompileError(f"interval arithmetic on kind {a.kind}")
    if op == "-":
        delta = -delta
    return NumCol(a.data + delta, a.kind, unit=a.unit)


# -- strings ----------------------------------------------------------------


def _dict_gather(col: StrCol, host_values: np.ndarray, kind: str) -> NumCol:
    """Evaluate per dictionary entry on the host, gather by code.  Null rows
    (code < 0) give False for predicates, the null sentinel otherwise."""
    dev = col.codes.device
    table = torch.from_numpy(np.ascontiguousarray(host_values)).to(dev)
    g = table[torch.clamp(col.codes, min=0).long()]
    isnull = col.codes < 0
    if kind == "b":
        g = g & ~isnull
    elif kind == "f":
        g = torch.where(isnull, torch.full((), float("nan"), dtype=g.dtype, device=dev), g)
    else:
        sent = NULL_I32 if g.dtype != torch.int64 else -(2**63)
        g = torch.where(isnull, torch.full((), sent, dtype=g.dtype, device=dev), g)
    return NumCol(g, kind)


def _notnone(d: StringDict) -> np.ndarray:
    none = d.none_entries
    if none is None:
        return np.ones(len(d), dtype=bool)
    return ~none


def _string_compare(op, a, b):
    if isinstance(a, str) and isinstance(b, StrCol):
        a, b, op = b, a, _flip(op)
    if isinstance(a, StrCol) and isinstance(b, str):
        vals = a.dictionary.values.astype(str)
        nn = _notnone(a.dictionary)
        if op == "=":
            return _dict_gather(a, (vals == b) & nn, "b")
        if op == "!=":
            return _dict_gather(a, (vals != b) & nn, "b")
        cmp = {"<": vals < b, "<=": vals <= b, ">": vals > b, ">=": vals >= b}[op]
        return _dict_gather(a, cmp & nn, "b")
    if isinstance(a, StrCol) and isinstance(b, StrCol):
        if op not in ("=", "!="):
            raise CompileError("ordering comparison between two string columns (todo)")
        ahi, alo = a.hash_limbs()
        bhi, blo = b.hash_limbs()
        eq = (ahi == bhi) & (alo == blo)
        out = eq if op == "=" else ~eq
        return NumCol(out & ~null_mask(a) & ~null_mask(b), "b")
    raise CompileError(f"string comparison {type(a)} {op} {type(b)}")


def _flip(op):
    return {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}[op]


_NEG_CMP = {"=": "!=", "!=": "=", "<": ">=", "<=": ">", ">": "<=", ">=": "<"}


def _negate_expr(e: Expr) -> Optional[Expr]:
    """Push a logical NOT one level down, or None if it can't be pushed."""
    if isinstance(e, BinOp):
        if e.op in _NEG_CMP:
            return BinOp(_NEG_CMP[e.op], e.left, e.right)
        if e.op in ("and", "or"):
            la, lb = _negate_expr(e.left), _negate_expr(e.right)
            if la is None:
                la = UnaryOp("not", e.left)
            if lb is None:
                lb = UnaryOp("not", e.right)
            return BinOp("or" if e.op == "and" else "and", la, lb)
        return None
    if isinstance(e, UnaryOp) and e.op == "not":
        return e.operand
    if isinstance(e, IsNull):
        return IsNull(e.expr, negated=not e.negated)
    if isinstance(e, InList):
        return InList(e.expr, e.values, negated=not e.negated)
    return None


def _like_to_regex(pat: str) -> str:
    out = []
    for ch in pat:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


def _str_op(e: StrOp, batch: DeviceBatch):
    v = evaluate(e.expr, batch)
    if not isinstance(v, StrCol):
        raise CompileError(f"str op {e.op} on non-string")
    if e.op in DICT_TRANSFORMS:
        return _dict_transform(v, (e.op, tuple(e.args)))
    svals = v.dictionary.values.astype(str)
    if e.op == "like":
        rx = re.compile(_like_to_regex(e.args[0]))
        return _dict_gather(v, np.array([bool(rx.match(s)) for s in svals]), "b")
    if e.op == "contains":
        return _dict_gather(v, np.char.find(svals, e.args[0]) >= 0, "b")
    if e.op == "starts_with":
        return _dict_gather(v, np.char.startswith(svals, e.args[0]), "b")
    if e.op == "ends_with":
        return _dict_gather(v, np.char.endswith(svals, e.args[0]), "b")
    if e.op == "length":
        return _dict_gather(v, np.char.str_len(svals).astype(np.int32), "i")
    raise CompileError(f"str op {e.op} (not in quokka_tpu_torch yet)")


def _slice(svals: np.ndarray, args) -> np.ndarray:
    off, length = int(args[0]), args[1]
    end = None if length is None else off + int(length)
    return np.array([s[off:end] for s in svals.tolist()], dtype=str)


# string -> string transforms: (the dictionary's non-null values as a str
# array, the op's arguments) -> the new values
DICT_TRANSFORMS = {
    "lower": lambda svals, args: np.char.lower(svals),
    "upper": lambda svals, args: np.char.upper(svals),
    "strip": lambda svals, args: np.char.strip(svals),
    "slice": _slice,
}


def _dict_transform(col: StrCol, op: Tuple) -> StrCol:
    """Apply the transform ``op`` (a ``DICT_TRANSFORMS`` name and its
    arguments) to each dictionary value (null entries stay null) and
    deduplicate the result, so that equal values share one code: the new
    dictionary holds each distinct value once (``np.unique`` on the host)
    and the codes go through the inverse in one gather; null rows keep code
    -1.  The small-key partial aggregate buckets by code, so a dictionary
    that repeated a value would split its group.  The host half is cached
    on the dictionary, so a stage that reads the new column twice (an
    output and a predicate) does it once."""
    d = col.dictionary
    hit = d._transforms.get(op)
    if hit is None:
        none = d.none_entries
        keep = np.ones(len(d), dtype=bool) if none is None else ~none
        mapped = DICT_TRANSFORMS[op[0]](d.values[keep].astype(str), op[1])
        uniq, inv = np.unique(mapped, return_inverse=True)
        remap = np.full(len(d), -1, dtype=np.int32)
        remap[keep] = inv.astype(np.int32)
        hit = d._transforms[op] = (StringDict(uniq.astype(object)), remap, {})
    new_dict, remap, on_dev = hit
    table = on_dev.get(col.codes.device)
    if table is None:
        table = on_dev[col.codes.device] = torch.from_numpy(remap).to(col.codes.device)
    codes = torch.where(col.codes < 0, col.codes,
                        table[torch.clamp(col.codes, min=0).long()])
    return StrCol(codes.to(col.codes.dtype), new_dict)


def _in_list(e: InList, batch: DeviceBatch):
    v = evaluate(e.expr, batch)
    if isinstance(v, StrCol):
        mask = np.isin(v.dictionary.values.astype(str), [str(x) for x in e.values])
        out = _dict_gather(v, mask & _notnone(v.dictionary), "b")
    else:
        data = _numeric_data(v)
        if not torch.is_tensor(data):
            raise CompileError("IN over a scalar")
        acc = torch.zeros_like(data, dtype=torch.bool)
        for val in e.values:
            acc = acc | (data == val)
        out = NumCol(acc, "b")
    if e.negated:
        out = NumCol(~out.data, "b")
    if isinstance(v, (NumCol, StrCol)):
        out = NumCol(out.data & ~null_mask(v), "b")
    return out


def _is_null(e: IsNull, batch: DeviceBatch):
    v = evaluate(e.expr, batch)
    if isinstance(v, (StrCol, NumCol)):
        out = NumCol(null_mask(v), "b")
    else:
        out = NumCol(torch.zeros(batch.padded_len, dtype=torch.bool,
                                 device=batch.valid.device), "b")
    if e.negated:
        out = NumCol(~out.data, "b")
    return out


# -- dates ------------------------------------------------------------------


def _civil_from_days(days):
    """days since 1970-01-01 -> (year, month, day), Hinnant's algorithm."""
    fd = lambda x, y: torch.div(x, y, rounding_mode="floor")  # noqa: E731
    z = days + 719468
    era = fd(z, 146097)
    doe = z - era * 146097
    yoe = fd(doe - fd(doe, 1460) + fd(doe, 36524) - fd(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + fd(yoe, 4) - fd(yoe, 100))
    mp = fd(5 * doy + 2, 153)
    d = doy - fd(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, torch.full_like(mp, 3), torch.full_like(mp, -9))
    y = y + (m <= 2).to(y.dtype)
    return y, m, d


def _days_from_civil(y, m, d):
    fd = lambda x, q: torch.div(x, q, rounding_mode="floor")  # noqa: E731
    y = y - (m <= 2).to(y.dtype)
    era = fd(y, 400)
    yoe = y - era * 400
    mp = m + torch.where(m > 2, torch.full_like(m, -3), torch.full_like(m, 9))
    doy = fd(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + fd(yoe, 4) - fd(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def _dt_field(e: DtField, batch: DeviceBatch):
    v = evaluate(e.expr, batch)
    if not isinstance(v, NumCol) or v.kind != "d":
        raise CompileError(f"extract({e.field}) on non-date (timestamps: later slice)")
    days = v.data.to(torch.int64)
    if e.field in ("year", "month", "day"):
        y, m, d = _civil_from_days(days)
        out = {"year": y, "month": m, "day": d}[e.field].to(torch.int32)
    elif e.field == "weekday":
        out = ((days + 4) % 7).to(torch.int32)
    else:
        raise CompileError(f"extract({e.field}) from a date")
    # a null date gives a null field (the reference computes one from the
    # sentinel's day number)
    return NumCol(torch.where(null_mask(v), torch.full_like(out, NULL_I32), out), "i")


# -- misc scalar funcs ------------------------------------------------------


def _case(e: Case, batch: DeviceBatch):
    raw_vals = [evaluate(v, batch) for _, v in e.whens]
    raw_default = evaluate(e.default, batch) if e.default is not None else None
    if any(isinstance(v, (StrCol, str)) for v in raw_vals + [raw_default]):
        raise CompileError("string-valued CASE (not in quokka_tpu_torch yet)")
    dev = batch.valid.device
    default = (
        value_to_column(raw_default, batch)
        if raw_default is not None
        else NumCol(torch.full((batch.padded_len,), float("nan"),
                               dtype=torch.float64, device=dev), "f")
    )
    conds = [evaluate_predicate(cond, batch) for cond, _ in e.whens]
    vals = [value_to_column(v, batch) for v in raw_vals]
    dtype = default.data.dtype
    for v in vals:
        dtype = torch.promote_types(dtype, v.data.dtype)
    out = default.data.to(dtype)
    kind = "f" if dtype.is_floating_point else default.kind
    for c, vcol in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, vcol.data.to(dtype), out)
    return NumCol(out, kind)


def _cast(e: Cast, batch: DeviceBatch):
    v = evaluate(e.expr, batch)
    to = e.to
    if to.startswith(("double", "float", "real", "decimal", "numeric")):
        if isinstance(v, (int, float)):
            return float(v)
        if isinstance(v, StrCol):
            vals = np.array([float(x) if x not in (None, "") else np.nan
                             for x in v.dictionary.values])
            return _dict_gather(v, vals.astype(np.float64), "f")
        return NumCol(v.data.to(torch.float64), "f")
    if to.startswith(("int", "bigint", "smallint", "tinyint")):
        if isinstance(v, (int, float)):
            return int(v)
        return NumCol(v.data.to(torch.int64), "i")
    if to.startswith("bool"):
        return NumCol(_as_bool(v), "b")
    if to.startswith("date"):
        if isinstance(v, str):
            return _DateScalar(DateLit(v).days)
        if isinstance(v, NumCol):
            return NumCol(v.data.to(torch.int32), "d")
    raise CompileError(f"cast to {to} (not in quokka_tpu_torch yet)")


def _func(e: Func, batch: DeviceBatch):
    name = e.name
    args = [evaluate(a, batch) for a in e.args]
    dev = batch.valid.device
    if name in ("__nn0", "__nnhigh", "__nnlow", "__nncount"):
        # null-skipping wrappers injected by AggPlan.rewrite: nulls become the
        # aggregate's identity before the kernel aggregates
        v = args[0]
        if not isinstance(v, (NumCol, StrCol)):
            if name == "__nncount":
                return NumCol(torch.ones(batch.padded_len, dtype=torch.int32, device=dev), "i")
            return v
        nm = null_mask(v)
        if name == "__nncount":
            return NumCol((~nm).to(torch.int32), "i")
        if isinstance(v, StrCol):
            raise CompileError("numeric aggregate over a string column")
        if v.kind == "f":
            repl = {"__nn0": 0.0, "__nnhigh": float("inf"), "__nnlow": float("-inf")}[name]
        elif v.kind == "b":
            return v
        else:
            ii = torch.iinfo(v.data.dtype)
            repl = {"__nn0": 0, "__nnhigh": ii.max, "__nnlow": ii.min}[name]
        return NumCol(torch.where(nm, torch.full((), repl, dtype=v.data.dtype, device=dev),
                                  v.data), v.kind, unit=v.unit)
    if name == "abs":
        return NumCol(torch.abs(args[0].data), args[0].kind)
    if name == "round":
        nd = int(args[1]) if len(args) > 1 else 0
        return NumCol(torch.round(args[0].data.to(torch.float64), decimals=nd), "f")
    if name == "sqrt":
        return NumCol(torch.sqrt(args[0].data.to(torch.float64)), "f")
    if name == "coalesce":
        v = args[0]
        if not isinstance(v, NumCol):
            return v
        kind, out = v.kind, v.data
        for nxt in args[1:]:
            nm = null_mask(NumCol(out, kind))
            nxt_data = nxt.data if isinstance(nxt, NumCol) else nxt
            if isinstance(nxt, NumCol) and nxt.kind == "f" and kind != "f":
                out = out.to(torch.float64)
                kind = "f"
                nm = torch.isnan(out) | nm
            if not torch.is_tensor(nxt_data):
                nxt_data = torch.full((), nxt_data, dtype=out.dtype, device=dev)
            out = torch.where(nm, nxt_data.to(out.dtype), out)
        return NumCol(out, kind)
    raise CompileError(f"function {name} (not in quokka_tpu_torch yet)")


# ---------------------------------------------------------------------------
# aggregation decomposition (partial -> final)
# ---------------------------------------------------------------------------


class AggPlan:
    """Decomposed aggregation:
    - pre: [(tmp_name, Expr)]           per-batch scalar columns to compute
    - partials: [(pname, op, tmp|None)] kernel aggs over (keys, tmp columns)
    - recombine: [(pname, op)]          how to merge partial results
    - finals: [(out_name, Expr over partial names)]
    """

    def __init__(self):
        self.pre: List[Tuple[str, Expr]] = []
        self.partials: List[Tuple[str, str, Optional[str]]] = []
        self.recombine: List[Tuple[str, str]] = []
        self.finals: List[Tuple[str, Expr]] = []
        self._memo: Dict[str, str] = {}

    def _tmp(self, e: Expr) -> str:
        key = "pre:" + e.sql()
        if key in self._memo:
            return self._memo[key]
        name = f"__pre_{len(self.pre)}"
        self.pre.append((name, e))
        self._memo[key] = name
        return name

    def _partial(self, op: str, arg: Optional[Expr]) -> str:
        key = f"agg:{op}:{arg.sql() if arg is not None else '*'}"
        if key in self._memo:
            return self._memo[key]
        name = f"__agg_{len(self.partials)}"
        tmp = self._tmp(arg) if arg is not None else None
        self.partials.append((name, op, tmp))
        self.recombine.append((name, {"count": "sum"}.get(op, op)))
        self._memo[key] = name
        return name

    def rewrite(self, e: Expr) -> Expr:
        if isinstance(e, Agg):
            if e.distinct:
                raise CompileError("count(distinct) requires the holistic agg path")

            def nn_count(arg):
                if arg is None:
                    return ColRef(self._partial("count", None))
                return ColRef(self._partial("sum", Func("__nncount", [arg])))

            if e.op == "sum":
                return ColRef(self._partial("sum", Func("__nn0", [e.arg])))
            if e.op == "min":
                return ColRef(self._partial("min", Func("__nnhigh", [e.arg])))
            if e.op == "max":
                return ColRef(self._partial("max", Func("__nnlow", [e.arg])))
            if e.op == "count":
                return nn_count(e.arg)
            if e.op == "avg":
                s = ColRef(self._partial("sum", Func("__nn0", [e.arg])))
                return BinOp("/", s, nn_count(e.arg))
            if e.op in ("stddev", "var"):
                x = Func("__nn0", [e.arg])
                s1 = ColRef(self._partial("sum", x))
                s2 = ColRef(self._partial("sum", BinOp("*", x, x)))
                c = nn_count(e.arg)
                mean = BinOp("/", s1, c)
                var = BinOp("-", BinOp("/", s2, c), BinOp("*", mean, mean))
                return var if e.op == "var" else Func("sqrt", [var])
            raise CompileError(f"aggregate {e.op}")
        kids = e.children()
        if not kids:
            return e
        from quokka_tpu_torch.expression import _rebuild

        return _rebuild(e, [self.rewrite(k) for k in kids])


def plan_aggregation(outputs: Sequence[Expr]) -> AggPlan:
    """outputs: Alias-wrapped expressions containing Agg nodes."""
    plan = AggPlan()
    for i, e in enumerate(outputs):
        name = e.name if isinstance(e, Alias) else f"col{i}"
        inner = e.expr if isinstance(e, Alias) else e
        plan.finals.append((name, plan.rewrite(inner)))
    return plan


# ---------------------------------------------------------------------------
# Triton source generator
# ---------------------------------------------------------------------------

# column dtype -> (Triton dtype name, kind inferred inside fused programs;
# the reference re-infers kinds from dtypes there: dates read as ints)
_TL_DTYPE = {torch.float64: "tl.float64", torch.float32: "tl.float32",
             torch.int64: "tl.int64", torch.int32: "tl.int32", torch.bool: "tl.int1"}
_INT_MIN = {"tl.int64": -(2**63), "tl.int32": -(2**31)}
# all-true / all-false block vectors (``valid`` is the block's validity)
_TRUE = "(valid == valid)"
_FALSE = "(valid != valid)"


class _V:
    """A generated value: Triton code (a variable name or a literal), its
    kind ('f','i','d','b'), its Triton dtype, and whether it is a scalar
    constant (``py`` then holds the Python value)."""

    __slots__ = ("code", "kind", "dt", "scalar", "py")

    def __init__(self, code, kind, dt, scalar=False, py=None):
        self.code, self.kind, self.dt, self.scalar, self.py = code, kind, dt, scalar, py


def _promote(a: str, b: str) -> str:
    order = ["tl.int1", "tl.int32", "tl.int64", "tl.float32", "tl.float64"]
    return order[max(order.index(a), order.index(b))]


class TritonExpr:
    """Emit straight-line Triton code for expressions over loaded columns.

    ``columns`` maps an input column name to (variable name, torch dtype)
    or (variable name, torch dtype, kind); the variables hold the block's
    loaded values.  Without a kind, the kind follows the dtype (a date reads
    as an int, as inside the reference's fused programs).  Float literals
    are read from a float64 constants array (``consts``) so they keep full
    precision: Triton would otherwise type a Python float as float32."""

    def __init__(self, columns: Dict[str, Tuple]):
        self.columns = columns
        self.lines: List[str] = []
        self.consts: List[float] = []
        self._n = 0

    def _tmp(self, code: str) -> str:
        name = f"t{self._n}"
        self._n += 1
        self.lines.append(f"{name} = {code}")
        return name

    def _const_f(self, x: float) -> _V:
        self.consts.append(float(x))
        code = self._tmp(f"tl.load(consts_ptr + {len(self.consts) - 1})")
        return _V(code, "f", "tl.float64", scalar=True, py=float(x))

    def _scalar(self, x) -> _V:
        if isinstance(x, bool):
            return _V(_TRUE if x else _FALSE, "b", "tl.int1", True, x)
        if isinstance(x, int):
            return _V(repr(int(x)), "i", "tl.int64" if not -2**31 <= x < 2**31
                      else "tl.int32", True, x)
        if isinstance(x, float):
            return self._const_f(x)
        raise CompileError(f"literal {x!r} outside the fused subset")

    def null(self, v: _V) -> Optional[str]:
        if v.scalar or v.kind == "b":
            return None
        if v.dt in ("tl.float64", "tl.float32"):
            return f"({v.code} != {v.code})"
        return f"({v.code} == {_INT_MIN[v.dt]})"

    def bool_of(self, v: _V) -> str:
        if v.scalar:
            return _TRUE if v.py else _FALSE
        return v.code if v.dt == "tl.int1" else f"({v.code} != 0)"

    def value(self, e: Expr) -> _V:
        if isinstance(e, Alias):
            return self.value(e.expr)
        if isinstance(e, ColRef):
            if e.name not in self.columns:
                raise CompileError(f"column {e.name} is not an input of the fused kernel")
            var, dt, *kind = self.columns[e.name]
            if not kind:
                kind = ["b" if dt == torch.bool else "f" if dt.is_floating_point else "i"]
            return _V(var, kind[0], _TL_DTYPE[dt])
        if isinstance(e, Literal):
            return self._scalar(e.value)
        if isinstance(e, DateLit):
            return _V(repr(int(e.days)), "d", "tl.int32", True, int(e.days))
        if isinstance(e, BinOp):
            if isinstance(e.right, IntervalLit):
                return self._interval(e)
            return self._binop(e.op, self.value(e.left), self.value(e.right))
        if isinstance(e, UnaryOp):
            if e.op == "not":
                pushed = _negate_expr(e.operand)
                if pushed is not None:
                    return self.value(pushed)
                v = self.value(e.operand)
                return _V(self._tmp(f"~{self.bool_of(v)}"), "b", "tl.int1")
            if e.op == "-":
                v = self.value(e.operand)
                if v.scalar:
                    return self._scalar(-v.py)
                return _V(self._tmp(f"-{v.code}"), v.kind, v.dt)
            raise CompileError(e.op)
        if isinstance(e, IsNull):
            v = self.value(e.expr)
            nm = self.null(v)
            if nm is None:
                return _V(self._tmp(_TRUE if e.negated else _FALSE), "b", "tl.int1")
            return _V(self._tmp(f"~{nm}" if e.negated else nm), "b", "tl.int1")
        if isinstance(e, InList):
            v = self.value(e.expr)
            if v.scalar:
                raise CompileError("IN over a scalar")
            terms = []
            for val in e.values:
                if isinstance(val, str):
                    raise CompileError("string IN inside the fused subset")
                terms.append(f"({v.code} == {self._scalar(val).code})")
            acc = " | ".join(terms) if terms else _FALSE
            if e.negated:
                acc = f"~({acc})"
            nm = self.null(v)
            if nm is not None:
                acc = f"({acc}) & ~{nm}"
            return _V(self._tmp(acc), "b", "tl.int1")
        if isinstance(e, Case):
            return self._case(e)
        if isinstance(e, Func) and e.name in ("__nn0", "__nnhigh", "__nnlow", "__nncount"):
            return self._nn(e)
        if isinstance(e, DtField):
            return self._dt_field(e)
        raise CompileError(f"{type(e).__name__} {e.sql()} is outside the fused subset")

    def _floordiv(self, x: str, y: int) -> str:
        """Floor division of an int64 block by a positive constant: Triton's
        integer ``//`` truncates toward zero, which differs for negative x
        (days before 1970)."""
        q = self._tmp(f"{x} // {y}")
        return self._tmp(f"tl.where({x} - {q} * {y} < 0, {q} - 1, {q})")

    def _dt_field(self, e: DtField) -> _V:
        """extract(year|month|day) from a date column: Hinnant's
        civil-from-days in int64, as the evaluator's ``_civil_from_days``;
        a null date gives a null field."""
        v = self.value(e.expr)
        if v.scalar or v.kind != "d" or e.field not in ("year", "month", "day"):
            raise CompileError(f"extract({e.field}) outside the fused subset")
        fd = self._floordiv
        z = self._tmp(f"{v.code}.to(tl.int64) + 719468")
        era = fd(z, 146097)
        doe = self._tmp(f"{z} - {era} * 146097")
        yoe = fd(self._tmp(f"{doe} - {fd(doe, 1460)} + {fd(doe, 36524)} - {fd(doe, 146096)}"),
                 365)
        doy = self._tmp(f"{doe} - (365 * {yoe} + {fd(yoe, 4)} - {fd(yoe, 100)})")
        mp = fd(self._tmp(f"5 * {doy} + 2"), 153)
        m = self._tmp(f"tl.where({mp} < 10, {mp} + 3, {mp} - 9)")
        if e.field == "year":
            out = self._tmp(f"{yoe} + {era} * 400 + ({m} <= 2).to(tl.int64)")
        elif e.field == "month":
            out = m
        else:
            out = self._tmp(f"{doy} - {fd(self._tmp(f'153 * {mp} + 2'), 5)} + 1")
        res = self._tmp(f"tl.where({self.null(v)}, {_INT_MIN['tl.int32']}, "
                        f"{out}.to(tl.int32))")
        return _V(res, "i", "tl.int32")

    def _interval(self, e: BinOp) -> _V:
        a, iv = e.left, e.right
        if isinstance(a, DateLit) or (isinstance(a, BinOp) and isinstance(a.right, IntervalLit)):
            base = self.value(a)
            if base.scalar and base.kind == "d":
                if iv.months:
                    if iv.micros:
                        raise CompileError("mixed month+day intervals")
                    d = _add_months_scalar(base.py, -iv.months if e.op == "-" else iv.months)
                else:
                    d = base.py + (iv.days if e.op == "+" else -iv.days)
                return _V(repr(int(d)), "d", "tl.int32", True, int(d))
        raise CompileError("interval arithmetic on a column is outside the fused subset")

    def _binop(self, op, a: _V, b: _V) -> _V:
        if op in ("and", "or"):
            sym = "&" if op == "and" else "|"
            return _V(self._tmp(f"({self.bool_of(a)}) {sym} ({self.bool_of(b)})"),
                      "b", "tl.int1")
        if a.scalar and b.scalar:
            if op in _CMP:
                return self._scalar(bool(_CMP_FN[op](a.py, b.py)))
            raise CompileError("constant arithmetic inside the fused subset")
        if op in _CMP:
            sym = {"=": "==", "!=": "!="}.get(op, op)
            res = f"({a.code} {sym} {b.code})"
            for side in (a, b):
                nm = self.null(side) if side.kind in ("i", "d", "t", "f") else None
                if nm is not None:
                    res = f"{res} & ~{nm}"
            return _V(self._tmp(res), "b", "tl.int1")
        if op not in ("+", "-", "*", "/"):
            raise CompileError(f"operator {op} is outside the fused subset")
        ka = a.kind
        kb = b.kind
        if op == "/":
            kind = "f"
        elif "d" in (ka, kb) and op in ("+", "-"):
            kind = "i" if ka == kb == "d" else "d"
        elif "f" in (ka, kb):
            kind = "f"
        else:
            kind = "i"
        if op == "/":
            dt = "tl.float64"
            ca, cb = self._as_f64(a), self._as_f64(b)
        else:
            dt = self._arith_dtype(a, b)
            ca = a.code if a.scalar or a.dt == dt else f"{a.code}.to({dt})"
            cb = b.code if b.scalar or b.dt == dt else f"{b.code}.to({dt})"
        out = self._tmp(f"{ca} {op} {cb}")
        nulls = [self.null(s) for s in (a, b) if not s.scalar and s.kind in ("i", "d", "t")]
        nulls = [n for n in nulls if n is not None]
        if nulls:
            cond = " | ".join(nulls)
            if dt in ("tl.float64", "tl.float32"):
                fill = self._const_f(float("nan")).code
                out = self._tmp(f"tl.where({cond}, {fill}, {out})")
            else:
                out = self._tmp(f"tl.where({cond}, {_INT_MIN[dt]}, {out})")
        return _V(out, kind, dt)

    def _as_f64(self, v: _V) -> str:
        if v.scalar:
            return self._const_f(float(v.py)).code if not isinstance(v.py, float) else v.code
        return v.code if v.dt == "tl.float64" else f"{v.code}.to(tl.float64)"

    @staticmethod
    def _arith_dtype(a: _V, b: _V) -> str:
        if a.scalar:
            a, b = b, a
        if b.scalar:
            if isinstance(b.py, float) and a.dt not in ("tl.float64", "tl.float32"):
                return "tl.float64"
            if a.dt == "tl.int1":
                return "tl.int64"
            if b.dt == "tl.int64" and a.dt == "tl.int32":
                return "tl.int64"
            return a.dt
        return _promote(a.dt, b.dt)

    def _nn(self, e: Func) -> _V:
        v = self.value(e.args[0])
        if v.scalar:
            if e.name == "__nncount":
                return _V(self._tmp("tl.full(valid.shape, 1, tl.int32)"), "i", "tl.int32")
            return v
        nm = self.null(v)
        if e.name == "__nncount":
            code = "tl.full(valid.shape, 1, tl.int32)" if nm is None else f"(~{nm}).to(tl.int32)"
            return _V(self._tmp(code), "i", "tl.int32")
        if nm is None:
            return v
        if v.dt in ("tl.float64", "tl.float32"):
            repl = self._const_f({"__nn0": 0.0, "__nnhigh": float("inf"),
                                  "__nnlow": float("-inf")}[e.name]).code
        else:
            lo = _INT_MIN[v.dt]
            repl = {"__nn0": "0", "__nnhigh": str(-lo - 1), "__nnlow": str(lo)}[e.name]
        return _V(self._tmp(f"tl.where({nm}, {repl}, {v.code})"), v.kind, v.dt)

    def _case(self, e: Case) -> _V:
        vals = [self.value(v) for _, v in e.whens]
        if e.default is not None:
            default = self.value(e.default)
        else:
            default = self._const_f(float("nan"))
        conds = [self.bool_of(self.value(c)) for c, _ in e.whens]
        dt = default.dt
        for v in vals:
            dt = _promote(dt, v.dt)
        kind = "f" if dt in ("tl.float64", "tl.float32") else default.kind

        def cast(v: _V) -> str:
            if v.scalar:
                code = f"({v.code}).to({dt})" if v.dt == "tl.int1" else v.code
                return f"(tl.zeros(valid.shape, {dt}) + {code})"
            return v.code if v.dt == dt else f"{v.code}.to({dt})"

        out = self._tmp(cast(default))
        for c, v in zip(reversed(conds), reversed(vals)):
            out = self._tmp(f"tl.where({c}, {cast(v)}, {out})")
        return _V(out, kind, dt)
