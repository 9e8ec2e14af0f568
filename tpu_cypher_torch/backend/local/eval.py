"""Local expression evaluator: typed Expr -> per-row Python values.

This is the semantic oracle: the analog of the reference's
``FlinkSQLExprMapper``/``SparkSQLExprMapper`` (Expr -> engine column
expression), except we evaluate directly with reference Cypher semantics
(ternary logic, null propagation) from ``api.values`` / ``ir.functions``.
The TPU backend's kernels are validated against this evaluator.

Resolution rule (same as the reference mappers): if an expression IS a header
column, read the column — only compute otherwise. This makes ``Property(n,
'name')`` a column read while ``Property(m, 'k')`` over a map literal
computes."""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional

from ...api import types as T
from ...api.values import (
    CypherMap,
    Duration,
    Node,
    Relationship,
    cypher_equals,
    cypher_equivalent,
    order_key,
)
from ...ir import expr as E
from ...ir.functions import CypherTypeError, lookup as lookup_function
from ...relational.header import RecordHeader


class EvalError(Exception):
    pass


class Evaluator:
    def __init__(self, table, header: RecordHeader, parameters: Dict[str, Any]):
        self.table = table  # LocalTable
        self.header = header
        self.params = parameters or {}

    # ------------------------------------------------------------------

    def evaluate(self, expr: E.Expr) -> List[Any]:
        """Evaluate to one value per row."""
        col = self.header.get(expr) if self.header is not None else None
        if col is not None and col in self.table._cols:
            return self.table._cols[col]
        fn = self.row_fn(expr)
        return [fn(r) for r in self.table.row_dicts()]

    # ------------------------------------------------------------------

    def row_fn(self, expr: E.Expr) -> Callable[[Dict[str, Any]], Any]:
        """Compile expr -> fn(row_dict) -> value. row_dict: column -> value,
        plus local bindings under reserved keys ('\x00local:<name>')."""
        col = self.header.get(expr) if self.header is not None else None
        if col is not None and col in self.table._cols:
            return lambda r, c=col: r[c]

        if isinstance(expr, E.Var):
            if self.header is not None and self.header.has_path(expr.name):
                from ...relational.materialize import path_materializer

                return path_materializer(self.header, expr)
            mat = expr.cypher_type.material
            key = "\x00local:" + expr.name
            if isinstance(mat, (T.CTNodeType, T.CTRelationshipType)):
                # comprehension/quantifier locals shadow pattern variables
                # (lexical scoping); an element var with no header columns
                # can ONLY be such a local (e.g. the rel-isomorphism
                # ``none(x IN rs WHERE ...)`` predicates)
                try:
                    elem = self._element_fn(expr, node=isinstance(mat, T.CTNodeType))
                except KeyError:
                    elem = None

                def _elem_or_local(r, k=key, f=elem, name=expr.name):
                    if k in r:
                        return r[k]
                    if f is None:
                        raise EvalError(
                            f"Unbound variable {name!r} during evaluation"
                        )
                    return f(r)

                return _elem_or_local

            def _local(r, k=key, name=expr.name):
                if k in r:
                    return r[k]
                # unresolved variable = planner bug; do not silently null it
                raise EvalError(f"Unbound variable {name!r} during evaluation")

            return _local
        if isinstance(expr, E.Param):
            val = self.params.get(expr.name)
            return lambda r, v=val: v
        if isinstance(expr, E.Lit):
            return lambda r, v=expr.value: v
        if isinstance(expr, E.ListLit):
            fns = [self.row_fn(i) for i in expr.items]
            return lambda r: [f(r) for f in fns]
        if isinstance(expr, E.MapLit):
            fns = [self.row_fn(v) for v in expr.values]
            keys = expr.keys
            return lambda r: CypherMap(zip(keys, (f(r) for f in fns)))
        if isinstance(expr, E.Property):
            return self._property_fn(expr)
        if isinstance(expr, E.Id):
            inner = self.row_fn(expr.expr)

            def _id(r):
                v = inner(r)
                if v is None:
                    return None
                if isinstance(v, (Node, Relationship)):
                    return v.id
                raise CypherTypeError("id() on non-element")

            return _id
        if isinstance(expr, (E.StartNode, E.EndNode)):
            inner = self.row_fn(expr.expr)
            attr = "start" if isinstance(expr, E.StartNode) else "end"

            def _se(r):
                v = inner(r)
                if v is None:
                    return None
                return getattr(v, attr)

            return _se
        if isinstance(expr, E.HasLabel):
            inner = self.row_fn(expr.expr)
            label = expr.label

            def _hl(r):
                v = inner(r)
                if v is None:
                    return None
                return label in v.labels

            return _hl
        if isinstance(expr, E.HasType):
            inner = self.row_fn(expr.expr)
            rt = expr.rel_type

            def _ht(r):
                v = inner(r)
                if v is None:
                    return None
                return v.rel_type == rt

            return _ht
        if isinstance(expr, E.AliasExpr):
            return self.row_fn(expr.expr)
        if isinstance(expr, E.PrefixId):
            inner = self.row_fn(expr.expr)
            tag = expr.tag

            def _prefix(r):
                v = inner(r)
                if v is None:
                    return None
                return v | (tag << 54)

            return _prefix
        if isinstance(expr, E.Ands):
            fns = [self.row_fn(x) for x in expr.exprs]

            def _and(r):
                saw_null = False
                for f in fns:
                    v = f(r)
                    if v is False:
                        return False
                    if v is None:
                        saw_null = True
                return None if saw_null else True

            return _and
        if isinstance(expr, E.Ors):
            fns = [self.row_fn(x) for x in expr.exprs]

            def _or(r):
                saw_null = False
                for f in fns:
                    v = f(r)
                    if v is True:
                        return True
                    if v is None:
                        saw_null = True
                return None if saw_null else False

            return _or
        if isinstance(expr, E.Xor):
            lf, rf = self.row_fn(expr.lhs), self.row_fn(expr.rhs)

            def _xor(r):
                l, rr = lf(r), rf(r)
                if l is None or rr is None:
                    return None
                return bool(l) != bool(rr)

            return _xor
        if isinstance(expr, E.Not):
            f = self.row_fn(expr.expr)

            def _not(r):
                v = f(r)
                return None if v is None else (not v)

            return _not
        if isinstance(expr, E.IsNull):
            f = self.row_fn(expr.expr)
            return lambda r: f(r) is None
        if isinstance(expr, E.IsNotNull):
            f = self.row_fn(expr.expr)
            return lambda r: f(r) is not None
        if isinstance(expr, E.Equals):
            lf, rf = self.row_fn(expr.lhs), self.row_fn(expr.rhs)
            return lambda r: cypher_equals(lf(r), rf(r))
        if isinstance(expr, E.Neq):
            lf, rf = self.row_fn(expr.lhs), self.row_fn(expr.rhs)

            def _neq(r):
                v = cypher_equals(lf(r), rf(r))
                return None if v is None else (not v)

            return _neq
        if isinstance(expr, (E.LessThan, E.LessThanOrEqual, E.GreaterThan, E.GreaterThanOrEqual)):
            return self._comparison_fn(expr)
        if isinstance(expr, E.In):
            lf, rf = self.row_fn(expr.lhs), self.row_fn(expr.rhs)

            def _in(r):
                item, lst = lf(r), rf(r)
                if lst is None:
                    return None
                saw_null = item is None and len(lst) > 0
                for x in lst:
                    v = cypher_equals(item, x)
                    if v is True:
                        return True
                    if v is None:
                        saw_null = True
                return None if saw_null else False

            return _in
        if isinstance(expr, (E.StartsWith, E.EndsWith, E.Contains)):
            lf, rf = self.row_fn(expr.lhs), self.row_fn(expr.rhs)
            op = {
                E.StartsWith: str.startswith,
                E.EndsWith: str.endswith,
                E.Contains: str.__contains__,
            }[type(expr)]

            def _strpred(r):
                l, rr = lf(r), rf(r)
                if l is None or rr is None:
                    return None
                if not isinstance(l, str) or not isinstance(rr, str):
                    return None
                return op(l, rr)

            return _strpred
        if isinstance(expr, E.RegexMatch):
            lf, rf = self.row_fn(expr.lhs), self.row_fn(expr.rhs)

            def _re(r):
                l, rr = lf(r), rf(r)
                if l is None or rr is None:
                    return None
                return re.fullmatch(rr, l) is not None

            return _re
        if isinstance(expr, E.Neg):
            f = self.row_fn(expr.expr)

            def _neg(r):
                v = f(r)
                if v is None:
                    return None
                if isinstance(v, bool) or not isinstance(v, (int, float, Duration)):
                    raise CypherTypeError(f"Cannot negate {v!r}")
                return -v

            return _neg
        if isinstance(expr, E.ArithmeticExpr):
            return self._arith_fn(expr)
        if isinstance(expr, E.FunctionCall):
            return self._function_fn(expr)
        if isinstance(expr, E.CaseExpr):
            return self._case_fn(expr)
        if isinstance(expr, E.Index):
            ef, idxf = self.row_fn(expr.expr), self.row_fn(expr.index)

            def _index(r):
                c, i = ef(r), idxf(r)
                if c is None or i is None:
                    return None
                if isinstance(c, (list, tuple)):
                    if not isinstance(i, int) or isinstance(i, bool):
                        raise CypherTypeError("List index must be an integer")
                    if -len(c) <= i < len(c):
                        return c[i]
                    return None
                if isinstance(c, (dict, CypherMap)):
                    return c.get(i)
                if isinstance(c, (Node, Relationship)):
                    return c.properties.get(i)
                raise CypherTypeError(f"Cannot index {type(c).__name__}")

            return _index
        if isinstance(expr, E.ListSlice):
            ef = self.row_fn(expr.expr)
            ff = self.row_fn(expr.from_) if expr.from_ is not None else None
            tf = self.row_fn(expr.to) if expr.to is not None else None

            def _slice(r):
                c = ef(r)
                if c is None:
                    return None
                lo = ff(r) if ff else None
                hi = tf(r) if tf else None
                if (ff and lo is None) or (tf and hi is None):
                    return None
                return list(c[slice(lo, hi)])

            return _slice
        if isinstance(expr, E.ListComprehension):
            return self._comprehension_fn(expr)
        if isinstance(expr, E.Quantified):
            return self._quantified_fn(expr)
        if isinstance(expr, E.Reduce):
            return self._reduce_fn(expr)
        if isinstance(expr, E.MapProjection):
            return self._map_projection_fn(expr)
        raise EvalError(f"Cannot evaluate {type(expr).__name__}: {expr.pretty_expr()}")

    # ------------------------------------------------------------------

    def _element_fn(self, var: E.Var, node: bool):
        """Materialize an element value from its header columns."""
        from ...relational.materialize import (
            node_materializer,
            relationship_materializer,
        )

        if node:
            return node_materializer(self.header, var)
        return relationship_materializer(self.header, var)

    def _property_fn(self, expr: E.Property):
        inner = self.row_fn(expr.expr)
        key = expr.key
        from ...ir.functions import DURATION_ACCESSORS, TEMPORAL_ACCESSORS
        import datetime as _dt

        def _prop(r):
            v = inner(r)
            if v is None:
                return None
            if isinstance(v, (Node, Relationship)):
                return v.properties.get(key)
            if isinstance(v, (dict, CypherMap)):
                return v.get(key)
            if isinstance(v, Duration):
                acc = DURATION_ACCESSORS.get(key.lower())
                if acc is None:
                    raise CypherTypeError(f"Unknown duration accessor {key!r}")
                return acc(v)
            if isinstance(v, (_dt.date, _dt.datetime, _dt.time)):
                acc = TEMPORAL_ACCESSORS.get(key.lower())
                if acc is None:
                    raise CypherTypeError(f"Unknown temporal accessor {key!r}")
                return acc(v)
            raise CypherTypeError(f"Cannot access property {key!r} on {type(v).__name__}")

        return _prop

    def _comparison_fn(self, expr):
        lf, rf = self.row_fn(expr.lhs), self.row_fn(expr.rhs)
        kind = type(expr).__name__

        def cmp(l, rr):
            if l is None or rr is None:
                return None
            # numbers compare across int/float; strings with strings; else null
            num = lambda x: isinstance(x, (int, float)) and not isinstance(x, bool)
            if num(l) and num(rr):
                if isinstance(l, float) and math.isnan(l) or isinstance(rr, float) and math.isnan(rr):
                    return False
                c = (l > rr) - (l < rr)
            elif isinstance(l, str) and isinstance(rr, str):
                c = (l > rr) - (l < rr)
            elif isinstance(l, bool) and isinstance(rr, bool):
                c = (l > rr) - (l < rr)
            elif type(l) is type(rr) and hasattr(l, "__lt__") and not isinstance(l, (list, dict)):
                try:
                    c = (l > rr) - (l < rr)
                except TypeError:
                    return None
            elif isinstance(l, (list, tuple)) and isinstance(rr, (list, tuple)):
                lk = tuple(order_key(x) for x in l)
                rk = tuple(order_key(x) for x in rr)
                c = (lk > rk) - (lk < rk)
            else:
                return None
            if kind == "LessThan":
                return c < 0
            if kind == "LessThanOrEqual":
                return c <= 0
            if kind == "GreaterThan":
                return c > 0
            return c >= 0

        return lambda r: cmp(lf(r), rf(r))

    def _arith_fn(self, expr):
        lf, rf = self.row_fn(expr.lhs), self.row_fn(expr.rhs)
        op = type(expr).__name__
        import datetime as _dt

        def _num(x):
            return isinstance(x, (int, float)) and not isinstance(x, bool)

        def _apply(l, rr):
            if l is None or rr is None:
                return None
            if op == "Add":
                if isinstance(l, str) or isinstance(rr, str):
                    ls = l if isinstance(l, str) else _to_str_concat(l)
                    rs = rr if isinstance(rr, str) else _to_str_concat(rr)
                    return ls + rs
                if isinstance(l, (list, tuple)) or isinstance(rr, (list, tuple)):
                    ll = list(l) if isinstance(l, (list, tuple)) else [l]
                    rl = list(rr) if isinstance(rr, (list, tuple)) else [rr]
                    return ll + rl
                if isinstance(l, Duration) and isinstance(rr, Duration):
                    return l + rr
                if isinstance(l, Duration) and isinstance(rr, (_dt.date, _dt.datetime)):
                    return _add_duration(rr, l)
                if isinstance(rr, Duration) and isinstance(l, (_dt.date, _dt.datetime)):
                    return _add_duration(l, rr)
                if isinstance(l, Duration) and isinstance(rr, _dt.time):
                    return _add_duration_time(rr, l)
                if isinstance(rr, Duration) and isinstance(l, _dt.time):
                    return _add_duration_time(l, rr)
                if _num(l) and _num(rr):
                    return l + rr
                raise CypherTypeError(f"Cannot add {type(l).__name__} and {type(rr).__name__}")
            if op == "Subtract":
                if isinstance(l, Duration) and isinstance(rr, Duration):
                    return l - rr
                if isinstance(l, (_dt.date, _dt.datetime)) and isinstance(rr, Duration):
                    return _add_duration(l, -rr)
                if isinstance(l, _dt.time) and isinstance(rr, Duration):
                    return _add_duration_time(l, -rr)
                if _num(l) and _num(rr):
                    return l - rr
                raise CypherTypeError("Cannot subtract")
            if op == "Multiply" and isinstance(l, Duration) and _num(rr):
                return _scale_duration(l, rr)
            if op == "Multiply" and isinstance(rr, Duration) and _num(l):
                return _scale_duration(rr, l)
            if op == "Divide" and isinstance(l, Duration) and _num(rr):
                if rr == 0:
                    return None  # same NULL-on-zero contract as numeric /
                return _scale_duration(l, 1.0 / rr)
            if not (_num(l) and _num(rr)):
                raise CypherTypeError(f"Numeric operator {op} on non-numbers")
            if op == "Multiply":
                return l * rr
            if op == "Divide":
                if isinstance(l, int) and isinstance(rr, int):
                    if rr == 0:
                        # reference semantics: the engines' SQL division by
                        # zero is NULL, not an error (Spark/Flink; the TPU
                        # backend's masked device division agrees)
                        return None
                    q = abs(l) // abs(rr)
                    return q if (l >= 0) == (rr >= 0) else -q
                return l / rr if rr != 0 else (
                    float("nan") if l == 0 else math.copysign(float("inf"), l) * math.copysign(1, rr)
                )
            if op == "Modulo":
                if rr == 0:
                    if isinstance(l, int) and isinstance(rr, int):
                        return None  # reference SQL semantics: NULL
                    return float("nan")
                return math.fmod(l, rr) if isinstance(l, float) or isinstance(rr, float) else int(math.fmod(l, rr))
            if op == "Pow":
                return float(l) ** float(rr)
            raise EvalError(op)

        return lambda r: _apply(lf(r), rf(r))

    def _function_fn(self, expr: E.FunctionCall):
        f = lookup_function(expr.name)
        arg_fns = [self.row_fn(a) for a in expr.args]

        def _call(r):
            args = [fn(r) for fn in arg_fns]
            if f.null_prop and any(a is None for a in args):
                return None
            return f.fn(*args)

        return _call

    def _case_fn(self, expr: E.CaseExpr):
        operand = self.row_fn(expr.operand) if expr.operand is not None else None
        whens = [self.row_fn(w) for w in expr.whens]
        thens = [self.row_fn(t) for t in expr.thens]
        default = self.row_fn(expr.default) if expr.default is not None else None

        def _case(r):
            if operand is not None:
                base = operand(r)
                for w, t in zip(whens, thens):
                    # simple CASE compares with `=`: WHEN null never matches
                    if cypher_equals(base, w(r)) is True:
                        return t(r)
            else:
                for w, t in zip(whens, thens):
                    if w(r) is True:
                        return t(r)
            return default(r) if default is not None else None

        return _case

    def _comprehension_fn(self, expr: E.ListComprehension):
        lf = self.row_fn(expr.list_expr)
        key = "\x00local:" + expr.var.name
        where = self.row_fn(expr.where) if expr.where is not None else None
        proj = self.row_fn(expr.projection) if expr.projection is not None else None

        def _comp(r):
            lst = lf(r)
            if lst is None:
                return None
            out = []
            r2 = dict(r)
            for x in lst:
                r2[key] = x
                if where is not None and where(r2) is not True:
                    continue
                out.append(proj(r2) if proj is not None else x)
            return out

        return _comp

    def _quantified_fn(self, expr: E.Quantified):
        lf = self.row_fn(expr.list_expr)
        key = "\x00local:" + expr.var.name
        pred = self.row_fn(expr.predicate)
        kind = expr.kind

        def _quant(r):
            lst = lf(r)
            if lst is None:
                return None
            r2 = dict(r)
            results = []
            for x in lst:
                r2[key] = x
                results.append(pred(r2))
            trues = sum(1 for v in results if v is True)
            nulls = sum(1 for v in results if v is None)
            if kind == "any":
                return True if trues > 0 else (None if nulls else False)
            if kind == "all":
                falses = len(results) - trues - nulls
                return False if falses else (None if nulls else True)
            if kind == "none":
                return False if trues else (None if nulls else True)
            if kind == "single":
                if trues > 1:
                    return False
                if nulls:
                    return None
                return trues == 1
            raise EvalError(kind)

        return _quant

    def _reduce_fn(self, expr: E.Reduce):
        lf = self.row_fn(expr.list_expr)
        init = self.row_fn(expr.init)
        vkey = "\x00local:" + expr.var.name
        akey = "\x00local:" + expr.acc.name
        body = self.row_fn(expr.expr)

        def _reduce(r):
            lst = lf(r)
            if lst is None:
                return None
            acc = init(r)
            r2 = dict(r)
            for x in lst:
                r2[vkey] = x
                r2[akey] = acc
                acc = body(r2)
            return acc

        return _reduce

    def _map_projection_fn(self, expr: E.MapProjection):
        vf = self.row_fn(expr.var)
        item_fns = [
            (k, self.row_fn(v) if v is not None else None) for k, v in expr.items
        ]
        all_props = expr.all_props

        def _mp(r):
            base = vf(r)
            if base is None:
                return None
            out = CypherMap()
            if all_props:
                if isinstance(base, (Node, Relationship)):
                    out.update(base.properties)
                elif isinstance(base, dict):
                    out.update(base)
            for k, fn in item_fns:
                if fn is None:
                    if isinstance(base, (Node, Relationship)):
                        out[k] = base.properties.get(k)
                    else:
                        out[k] = base.get(k)
                else:
                    out[k] = fn(r)
            return out

        return _mp


def _to_str_concat(v):
    from ...api.values import to_cypher_string

    if isinstance(v, (int,)) and not isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        return to_cypher_string(v)
    if isinstance(v, bool):
        return "true" if v else "false"
    raise CypherTypeError(f"Cannot concatenate {type(v).__name__} with string")


def _scale_duration(d: Duration, factor) -> Duration:
    """duration * number / duration / number (reference ``TemporalConversions``
    duration arithmetic): component-wise scale, fractional parts cascade via
    ``Duration.of``."""
    return Duration.of(
        months=d.months * factor,
        days=d.days * factor,
        seconds=d.seconds * factor,
        microseconds=d.microseconds * factor,
    )


def _add_duration_time(t_val, dur: Duration):
    """time/localtime +/- duration: only the sub-day components apply and
    the clock wraps modulo 24h (Neo4j time arithmetic); the zone offset is
    preserved."""
    import datetime as _dt

    us = (
        (t_val.hour * 3600 + t_val.minute * 60 + t_val.second) * 1_000_000
        + t_val.microsecond
    )
    us = (us + dur.seconds * 1_000_000 + dur.microseconds) % 86_400_000_000
    secs, micro = divmod(us, 1_000_000)
    h, rem = divmod(secs, 3600)
    m, s = divmod(rem, 60)
    return _dt.time(int(h), int(m), int(s), int(micro), tzinfo=t_val.tzinfo)


def _add_duration(dt_val, dur: Duration):
    import datetime as _dt

    try:
        months = dt_val.month - 1 + dur.months
        year = dt_val.year + months // 12
        month = months % 12 + 1
        try:
            base = dt_val.replace(year=year, month=month)
        except ValueError:
            # clamp day to month end
            import calendar

            day = min(dt_val.day, calendar.monthrange(year, month)[1])
            base = dt_val.replace(year=year, month=month, day=day)
        delta = _dt.timedelta(
            days=dur.days, seconds=dur.seconds, microseconds=dur.microseconds
        )
        if isinstance(base, _dt.datetime):
            return base + delta
        result = _dt.datetime(base.year, base.month, base.day) + delta
    except (ValueError, OverflowError) as exc:
        # years outside [1, 9999]: a TYPED engine error, not a raw
        # ValueError (the device backend defers to this exact error)
        raise CypherTypeError(f"temporal result out of range: {exc}") from exc
    if isinstance(dt_val, _dt.datetime):
        return result
    return result.date() if (result.hour, result.minute, result.second, result.microsecond) == (0, 0, 0, 0) else result


# ---------------------------------------------------------------------------
# aggregation semantics (shared with group())
# ---------------------------------------------------------------------------


def aggregate_values(name: str, values: List[Any], distinct: bool, extra: List[Any]) -> Any:
    """Reference semantics of Cypher aggregators over a group's values.

    Nulls are skipped (Cypher aggregation ignores null inputs)."""
    vals = [v for v in values if v is not None]
    if distinct:
        seen = []
        uniq = []
        from ...api.values import _equiv_key

        keys = set()
        for v in vals:
            k = _equiv_key(v)
            if k not in keys:
                keys.add(k)
                uniq.append(v)
        vals = uniq
    if name == "count":
        return len(vals)
    if name == "collect":
        return vals
    if name == "sum":
        if not vals:
            return 0
        if isinstance(vals[0], Duration):
            out = Duration()
            for v in vals:
                out = out + v
            return out
        return sum(vals)
    if name == "avg":
        if not vals:
            return None
        if isinstance(vals[0], Duration):
            total = Duration()
            for v in vals:
                total = total + v
            k = len(vals)
            return Duration(total.months // k, total.days // k, total.seconds // k, total.microseconds // k)
        return sum(vals) / len(vals)
    if name == "min":
        return min(vals, key=order_key) if vals else None
    if name == "max":
        return max(vals, key=order_key) if vals else None
    if name in ("stdev", "stdevp"):
        if len(vals) < 2:
            return 0.0 if vals else 0.0
        mean = sum(vals) / len(vals)
        denom = len(vals) - (1 if name == "stdev" else 0)
        return math.sqrt(sum((v - mean) ** 2 for v in vals) / denom)
    if name == "percentilecont":
        if not vals:
            return None
        p = extra[0]
        if not 0 <= p <= 1:
            raise CypherTypeError("percentile must be in [0,1]")
        s = sorted(vals)
        idx = p * (len(s) - 1)
        lo, hi = int(math.floor(idx)), int(math.ceil(idx))
        if lo == hi:
            return float(s[lo])
        frac = idx - lo
        return s[lo] * (1 - frac) + s[hi] * frac
    if name == "percentiledisc":
        if not vals:
            return None
        p = extra[0]
        if not 0 <= p <= 1:
            raise CypherTypeError("percentile must be in [0,1]")
        s = sorted(vals)
        idx = math.ceil(p * len(s)) - 1 if p > 0 else 0
        return s[max(0, min(idx, len(s) - 1))]
    raise EvalError(f"Unknown aggregator {name}")
