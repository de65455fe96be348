# ported from tidb_tpu/expr/compile.py @ 9d319cb
"""Host expression evaluator with MySQL NULL + decimal semantics.

Reference analog: pkg/expression's vectorized builtins
(builtin_*_vec.go, VectorizedExecute chunk_executor.go:99).  One
recursive compiler lowers the IR to numpy array ops: the host-side
evaluation of the planner's constant folding and of the root
executors' residue (expressions the capability registry refuses to push
down, SURVEY.md §A.1).  The JAX package runs the same ``Evaluator``
over ``jax.numpy`` inside its device programs; in the port the device
lanes are the torch ``Evaluator`` of ``expr/compile.py``, and this
module runs on numpy only (``eval_expr(np, ...)``, the JAX package's
call form).

Every node evaluates to a pair ``(value, valid)``:

- value: array in device representation (scaled ints for DECIMAL, dict codes
  for STRING, days/micros for temporal); comparisons/logic yield bool arrays.
- valid: bool array, or the literal ``True`` meaning "all valid" (so
  non-nullable columns never materialize a mask).

Three-valued logic, NULL propagation, decimal rescaling, and MySQL rounding
all live here, golden-tested against python Decimal in tests/test_expr.py.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from ..types import dtypes as dt
from ..types import decimal as dec
from .ir import ColumnRef, Const, Expr, Func

K = dt.TypeKind

Pair = tuple[Any, Any]  # (value, valid)


# extension scalar functions (tidb_tpu/extension): name -> (callable,
# arity); evaluated host-side row-at-a-time via Evaluator._ext_func
EXTENSION_FUNCS: dict = {}


def _jan1(xp, y):
    """Days-since-epoch of January 1st of year(s) y."""
    from ..types.temporal import days_from_civil
    return days_from_civil(xp, y, 1, 1)


def vand(a, b):
    if a is True:
        return b
    if b is True:
        return a
    return a & b


class Evaluator:
    """Evaluate IR over columns. `xp` = numpy or jax.numpy.

    `dicts` (host evaluation only) maps column index -> StringDict; with
    it, string functions that dictionary lowering could not rewrite fall
    back to per-row python evaluation — the residual row-wise builtin
    path of the reference (builtin_string.go evalString loops)."""

    def __init__(self, xp, dicts=None):
        self.xp = xp
        self.dicts = dicts

    # -- public entry ---------------------------------------------------- #

    def eval(self, e: Expr, cols: Sequence[Pair], memo: dict | None = None) -> Pair:
        if memo is None:
            memo = {}
        key = id(e)
        if key in memo:
            return memo[key]
        out = self._eval(e, cols, memo)
        memo[key] = out
        return out

    # -- dispatch -------------------------------------------------------- #

    def _eval(self, e: Expr, cols, memo) -> Pair:
        if isinstance(e, ColumnRef):
            return cols[e.index]
        if isinstance(e, Const):
            if e.value is None:
                return self.xp.int64(0), False
            if isinstance(e.value, np.ndarray):
                return self.xp.asarray(e.value), True
            return e.value, True
        assert isinstance(e, Func)
        if e.op.startswith("ext:"):
            return self._ext_func(e, cols, memo)
        fn = getattr(self, f"op_{e.op}", None)
        if fn is None:
            raise NotImplementedError(f"op {e.op}")
        return fn(e, cols, memo)

    def _ext_func(self, e: Func, cols, memo) -> Pair:
        """Extension scalar function (pkg/extension function point): a
        registered host python callable applied row-at-a-time — HOST
        evaluation only (never device-fused; _device_supported excludes
        ext: ops)."""
        ext = EXTENSION_FUNCS.get(e.op[4:])
        if ext is None:
            raise NotImplementedError(f"extension function {e.op[4:]}")
        fn, _arity = ext
        vals = [self.eval(a, cols, memo) for a in e.args]
        n = 1
        for v, _m in vals:
            if getattr(v, "ndim", 0):
                n = max(n, len(v))
        out = np.empty(n, np.float64)
        ok = np.ones(n, bool)
        for i in range(n):
            row = []
            null = False
            for v, m in vals:
                mv = m if m is True else (bool(m[i]) if getattr(
                    m, "ndim", 0) else bool(m))
                if not mv:
                    null = True
                    break
                row.append(v[i].item() if getattr(v, "ndim", 0) else v)
            if null:
                ok[i] = False
                out[i] = 0.0
                continue
            r = fn(*row)
            if r is None:
                ok[i] = False
                out[i] = 0.0
            else:
                out[i] = float(r)
        return self.xp.asarray(out), (True if ok.all()
                                      else self.xp.asarray(ok))

    # -- helpers --------------------------------------------------------- #

    def _num(self, a: Expr, cols, memo, as_kind: K | None = None):
        """Evaluate a numeric operand; cast bool compare-results to int."""
        v, m = self.eval(a, cols, memo)
        if getattr(v, "dtype", None) is not None and v.dtype == bool:
            v = v.astype(self.xp.int64)
        elif isinstance(v, bool):
            v = int(v)
        return v, m

    # -- narrow physical columns (chunk.Column.narrowed) ----------------- #
    #
    # Scans may hand the evaluator int8/int16/int32 arrays holding int64/
    # decimal/date logical values (the frame-of-reference column encoding:
    # 1-4 bytes/row of memory traffic instead of 8).  Integer arithmetic
    # must then compute at full width — numpy/jnp promotion would keep the
    # narrow width and overflow.  np: ufunc dtype= computes widened without
    # materializing upcast temporaries; jnp: astype converts fuse into the
    # surrounding XLA kernel.

    def _iwiden(self, op: str, va, vb, unsigned: bool):
        xp = self.xp
        tgt = xp.uint64 if unsigned else xp.int64
        if xp is np:
            # object arrays (exact python-int wide decimals) and pure
            # python scalars keep python arithmetic — exact at any
            # magnitude; the ufunc dtype= kwarg cannot cast the former
            # and would wrap/raise on >64-bit literals for the latter
            da = getattr(va, "dtype", None)
            db = getattr(vb, "dtype", None)
            if (da is not None and da.kind == "O") \
                    or (db is not None and db.kind == "O") \
                    or (da is None and db is None):
                return {"add": lambda: va + vb,
                        "subtract": lambda: va - vb,
                        "multiply": lambda: va * vb}[op]()
            return getattr(np, op)(va, vb, dtype=tgt)
        if getattr(va, "dtype", None) is not None and va.dtype != tgt:
            va = va.astype(tgt)
        if getattr(vb, "dtype", None) is not None and vb.dtype != tgt:
            vb = vb.astype(tgt)
        return {"add": xp.add, "subtract": xp.subtract,
                "multiply": xp.multiply}[op](va, vb)

    @staticmethod
    def _is_narrow(v) -> bool:
        d = getattr(v, "dtype", None)
        return d is not None and d.kind in "iu" and d.itemsize < 8

    def _cmp_fit(self, va, vb):
        """Make a (narrow array, int scalar) comparison width-safe AND
        narrow-fast: a literal that fits the array's physical dtype is cast
        down (the compare then runs at physical width); one that does not
        fit widens the array side (numpy NEP50 would raise OverflowError,
        jnp would silently wrap)."""
        for x, y, flip in ((va, vb, False), (vb, va, True)):
            if self._is_narrow(x) and isinstance(y, (int, np.integer)) \
                    and getattr(y, "ndim", 0) == 0:
                info = np.iinfo(x.dtype)
                if info.min <= int(y) <= info.max:
                    y = x.dtype.type(y)
                else:
                    x = x.astype(self.xp.int64)
                return (y, x) if flip else (x, y)
            # int64 array vs a beyond-64-bit python literal (wide decimal
            # rescales): numpy would raise; compare in exact object ints
            d = getattr(x, "dtype", None)
            if d is not None and d.kind in "iu" and isinstance(y, int) \
                    and not (-2 ** 63 <= y < 2 ** 64):
                x = x.astype(object)
                return (y, x) if flip else (x, y)
        return va, vb

    def _to_common(self, e: Func, cols, memo):
        """Evaluate both operands and unify numeric representation."""
        xp = self.xp
        a, b = e.args
        va, ma = self._num(a, cols, memo)
        vb, mb = self._num(b, cols, memo)
        ka, kb = a.dtype.kind, b.dtype.kind
        if ka in (K.FLOAT64, K.FLOAT32) or kb in (K.FLOAT64, K.FLOAT32):
            va = self._as_double(va, a.dtype)
            vb = self._as_double(vb, b.dtype)
            return va, ma, vb, mb, dt.double()
        if ka == K.DECIMAL or kb == K.DECIMAL:
            sa = a.dtype.scale if ka == K.DECIMAL else 0
            sb = b.dtype.scale if kb == K.DECIMAL else 0
            s = max(sa, sb)
            if sa < s:
                va = self._iwiden("multiply", va, dec.pow10(s - sa), False)
            if sb < s:
                vb = self._iwiden("multiply", vb, dec.pow10(s - sb), False)
            return va, ma, vb, mb, dt.decimal(18, s)
        # DATE (days) vs DATETIME (micros): coerce DATE up, MySQL-style
        if {ka, kb} == {K.DATE, K.DATETIME}:
            from ..types.temporal import MICROS_PER_DAY
            if ka == K.DATE:
                va = _as_i64(xp, va) * MICROS_PER_DAY
            else:
                vb = _as_i64(xp, vb) * MICROS_PER_DAY
            return va, ma, vb, mb, dt.datetime()
        # mixed signed/unsigned BIGINT: numpy would silently promote to
        # float64 (lossy past 2^53); compute in uint64 two's complement and
        # let _cmp fix up sign-aware comparisons
        if {ka, kb} == {K.INT64, K.UINT64}:
            va = va.astype(xp.uint64) if hasattr(va, "astype") else xp.uint64(va)
            vb = vb.astype(xp.uint64) if hasattr(vb, "astype") else xp.uint64(vb)
            return va, ma, vb, mb, dt.ubigint()
        return va, ma, vb, mb, (a.dtype if ka != K.NULL else b.dtype)

    def _as_double(self, v, t: dt.DataType):
        xp = self.xp
        if t.kind == K.DECIMAL:
            return v.astype(xp.float64) / float(dec.pow10(t.scale)) \
                if hasattr(v, "astype") else float(v) / dec.pow10(t.scale)
        if hasattr(v, "astype"):
            return v.astype(xp.float64)
        return float(v)

    def _truthy(self, e: Expr, cols, memo) -> Pair:
        """MySQL truthiness: nonzero numeric = true.  Scalar results are
        wrapped as xp.bool_ so ``~``/``&`` keep boolean semantics (a python
        bool would turn ``~True`` into -2 and poison validity masks)."""
        v, m = self.eval(e, cols, memo)
        if getattr(v, "dtype", None) is not None and v.dtype == bool:
            return v, m
        if isinstance(v, (bool, int, float)):
            return self.xp.bool_(v != 0), m
        return v != 0, m

    # -- arithmetic ------------------------------------------------------ #

    _INT_FAMILY = (K.INT64, K.UINT64, K.DECIMAL, K.DATE, K.DATETIME,
                   K.TIME)

    def _arith(self, op: str, va, vb, t):
        """Add/sub/mul honoring the logical (int64/uint64) width when a
        physical operand is narrow."""
        if t.kind in self._INT_FAMILY and (self._is_narrow(va)
                                           or self._is_narrow(vb)):
            return self._iwiden(op, va, vb, t.kind == K.UINT64)
        return {"add": lambda: va + vb, "subtract": lambda: va - vb,
                "multiply": lambda: va * vb}[op]()

    _I64_MIN = -2 ** 63

    def _guard_dec_overflow(self, op: str, va, vb, r, m) -> None:
        """int64 scalar-op overflow guard for DECIMAL arithmetic (the
        gap expr/builders._arith_result_type documents): a scaled-int64
        result that wrapped past 2^63 reads back as a wrong decimal with
        no error.  Host (numpy) evaluation detects the wrap on VALID
        lanes and raises — MySQL's "value is out of range" discipline —
        instead of returning wrapped digits.  Device (jnp) lanes cannot
        raise data-dependently inside a traced program and stay
        unguarded (the builders comment narrows to exactly that).

        The multiply check divides the wrapped product back: exact for
        two's-complement wrap (q != a whenever a*b left int64, plus the
        (INT64_MIN, -1) floor-division special case)."""
        if self.xp is not np or not isinstance(r, np.ndarray) \
                or r.dtype.kind != "i":
            return            # device lanes / object-int (exact) / scalar
        a, b = np.asarray(va), np.asarray(vb)
        if a.dtype.kind not in "iu" or b.dtype.kind not in "iu":
            return
        a = a.astype(np.int64, copy=False)
        b = b.astype(np.int64, copy=False)
        if op == "add":
            bad = ((b > 0) & (r < a)) | ((b < 0) & (r > a))
        elif op == "subtract":
            bad = ((b < 0) & (r < a)) | ((b > 0) & (r > a))
        else:
            nz = b != 0
            with np.errstate(over="ignore"):
                q = np.floor_divide(r, np.where(nz, b, 1))
            bad = (nz & (q != a)) \
                | ((a == self._I64_MIN) & (b == -1))
        if m is not True:
            bad = bad & m
        if np.any(bad):
            raise OverflowError(
                "DECIMAL value is out of range: scaled int64 "
                f"{'+' if op == 'add' else '-' if op == 'subtract' else '*'}"
                " overflowed 18 digits (narrow the operands or cast to "
                "DOUBLE)")

    def op_add(self, e, cols, memo):
        va, ma, vb, mb, t = self._to_common(e, cols, memo)
        r, m = self._arith("add", va, vb, t), vand(ma, mb)
        if t.kind == K.DECIMAL:
            self._guard_dec_overflow("add", va, vb, r, m)
        return r, m

    def op_sub(self, e, cols, memo):
        va, ma, vb, mb, t = self._to_common(e, cols, memo)
        r, m = self._arith("subtract", va, vb, t), vand(ma, mb)
        if t.kind == K.DECIMAL:
            self._guard_dec_overflow("subtract", va, vb, r, m)
        return r, m

    def op_mul(self, e, cols, memo):
        a, b = e.args
        if e.dtype.kind == K.DECIMAL:
            # scales add: no rescale needed before the integer multiply
            va, ma = self._num(a, cols, memo)
            vb, mb = self._num(b, cols, memo)
            r, m = self._arith("multiply", va, vb, e.dtype), vand(ma, mb)
            self._guard_dec_overflow("multiply", va, vb, r, m)
            return r, m
        va, ma, vb, mb, t = self._to_common(e, cols, memo)
        return self._arith("multiply", va, vb, t), vand(ma, mb)

    def op_div(self, e, cols, memo):
        xp = self.xp
        a, b = e.args
        if e.dtype.kind == K.DECIMAL:
            sa = a.dtype.scale if a.dtype.kind == K.DECIMAL else 0
            sb = b.dtype.scale if b.dtype.kind == K.DECIMAL else 0
            k = e.dtype.scale - sa + sb
            va, ma = self._num(a, cols, memo)
            vb, mb = self._num(b, cols, memo)
            # k < 0 (result scale capped below dividend scale): scale the
            # divisor instead — pow10 must stay integral to keep exactness.
            if k >= 0:
                num = self._iwiden("multiply", va, dec.pow10(k), False)
                # the pre-scaling multiply wraps exactly like any other
                # scaled-int64 multiply — exact divide-back guard on
                # host lanes (device lanes: valueflow NUM-DIV-PRESCALE
                # proves the interval pre-trace)
                self._guard_dec_overflow("multiply", va, dec.pow10(k),
                                         num, vand(ma, mb))
                den = _as_i64(xp, vb) if self._is_narrow(vb) else vb
            else:
                num = _as_i64(xp, va) if self._is_narrow(va) else va
                den = self._iwiden("multiply", vb, dec.pow10(-k), False)
                self._guard_dec_overflow("multiply", vb, dec.pow10(-k),
                                         den, vand(ma, mb))
            return (_round_div(xp, num, den), _div_valid(xp, ma, mb, vb))
        va, ma = self._num(a, cols, memo)
        vb, mb = self._num(b, cols, memo)
        va = self._as_double(va, a.dtype)
        vb = self._as_double(vb, b.dtype)
        safe = xp.where(vb == 0, 1.0, vb)
        return va / safe, _div_valid(xp, ma, mb, vb)

    def op_intdiv(self, e, cols, memo):
        xp = self.xp
        va, ma, vb, mb, t = self._to_common(e, cols, memo)
        if self._is_narrow(va):
            va = _as_i64(xp, va)
        if self._is_narrow(vb):
            vb = _as_i64(xp, vb)
        if t.kind == K.FLOAT64:
            safe = xp.where(vb == 0, 1.0, vb)
            q = xp.trunc(va / safe).astype(xp.int64)
        else:
            q = _trunc_div(xp, va, vb)
        return q, _div_valid(xp, ma, mb, vb)

    def op_mod(self, e, cols, memo):
        xp = self.xp
        va, ma, vb, mb, t = self._to_common(e, cols, memo)
        if self._is_narrow(va):
            va = _as_i64(xp, va)
        if self._is_narrow(vb):
            vb = _as_i64(xp, vb)
        if t.kind == K.FLOAT64:
            safe = xp.where(vb == 0, 1.0, vb)
            r = va - xp.trunc(va / safe) * vb
        else:
            r = va - _trunc_div(xp, va, vb) * vb
        return r, _div_valid(xp, ma, mb, vb)

    def op_neg(self, e, cols, memo):
        v, m = self._num(e.args[0], cols, memo)
        if self._is_narrow(v):
            v = _as_i64(self.xp, v)    # -(INT_MIN of the narrow width)
        return -v, m

    def op_abs(self, e, cols, memo):
        v, m = self._num(e.args[0], cols, memo)
        if self._is_narrow(v):
            v = _as_i64(self.xp, v)
        return self.xp.abs(v), m

    # -- vector functions (host-only; types VectorFloat32 analog) -------- #

    def _vec_mat(self, arg, cols, memo):
        """(matrix (n|1, maxd) zero-padded, dims (n|1,), valid (n|1,),
        is_column) for one vector arg.  Zero-padding to the column's max
        dimension keeps norms/dots/distances exact per row, so an
        unconstrained VECTOR column may hold mixed dimensions; binary
        functions enforce per-ROW dimension equality (vector.go
        CheckVectorDims semantics)."""
        v, m = self.eval(arg, cols, memo)
        if isinstance(v, np.ndarray) and v.dtype == object:
            n = len(v)
            valid = np.array(_mask_arr(np, m, v), bool).copy()
            dims = np.zeros(n, np.int64)
            for i in range(n):
                if not valid[i] or v[i] is None:
                    valid[i] = False
                else:
                    dims[i] = len(v[i])
            maxd = int(dims.max()) if n else 0
            mat = np.zeros((n, maxd), np.float32)
            for i in range(n):
                if valid[i]:
                    mat[i, :dims[i]] = v[i]
            return mat, dims, valid, True
        if v is None or (not isinstance(v, np.ndarray) and m is False):
            return (np.zeros((1, 0), np.float32), np.zeros(1, np.int64),
                    np.array([False]), False)
        arr = np.asarray(v, np.float32).reshape(1, -1)
        return (arr, np.full(1, arr.shape[1], np.int64),
                np.array([bool(m) if m in (True, False) else True]), False)

    def _vec_binary(self, e, cols, memo, fn):
        a, da, va, acol = self._vec_mat(e.args[0], cols, memo)
        b, db, vb, bcol = self._vec_mat(e.args[1], cols, memo)
        valid = va & vb
        # per-row dimension check over the rows that actually pair up
        nrows = max(len(da), len(db))
        pa = np.broadcast_to(da, (nrows,))
        pb = np.broadcast_to(db, (nrows,))
        pv = np.broadcast_to(valid, (nrows,))
        if bool(((pa != pb) & pv).any()):
            raise ValueError("vectors have different dimensions")
        d = max(a.shape[1], b.shape[1])
        if a.shape[1] != d:
            a = np.pad(a, ((0, 0), (0, d - a.shape[1])))
        if b.shape[1] != d:
            b = np.pad(b, ((0, 0), (0, d - b.shape[1])))
        out = fn(a.astype(np.float64), b.astype(np.float64))
        if not acol and not bcol:
            return float(out[0]), bool(valid[0])
        return out, valid

    def op_vec_l2_distance(self, e, cols, memo):
        return self._vec_binary(
            e, cols, memo,
            lambda a, b: np.sqrt(((a - b) ** 2).sum(axis=1)))

    def op_vec_l1_distance(self, e, cols, memo):
        return self._vec_binary(
            e, cols, memo, lambda a, b: np.abs(a - b).sum(axis=1))

    def op_vec_negative_inner_product(self, e, cols, memo):
        return self._vec_binary(
            e, cols, memo, lambda a, b: -(a * b).sum(axis=1))

    def op_vec_cosine_distance(self, e, cols, memo):
        def cos(a, b):
            na = np.sqrt((a * a).sum(axis=1))
            nb = np.sqrt((b * b).sum(axis=1))
            denom = na * nb
            with np.errstate(divide="ignore", invalid="ignore"):
                out = 1.0 - (a * b).sum(axis=1) / denom
            return np.where(denom == 0, np.nan, out)
        v, m = self._vec_binary(e, cols, memo, cos)
        # zero-norm input: NULL (undefined angle)
        if isinstance(v, np.ndarray):
            bad = np.isnan(v)
            return np.where(bad, 0.0, v), _mask_arr(np, m, v) & ~bad
        return (0.0, False) if v != v else (v, m)

    def op_vec_dims(self, e, cols, memo):
        v, m = self.eval(e.args[0], cols, memo)
        if isinstance(v, np.ndarray) and v.dtype == object:
            valid = np.array(_mask_arr(np, m, v), bool).copy()
            out = np.zeros(len(v), np.int64)
            for i, x in enumerate(v):
                if valid[i] and x is not None:
                    out[i] = len(x)
                else:
                    valid[i] = False
            return out, valid
        arr = np.asarray(v, np.float32).reshape(-1)
        return np.int64(len(arr)), m

    def op_vec_l2_norm(self, e, cols, memo):
        mat, _dims, valid, col = self._vec_mat(e.args[0], cols, memo)
        out = np.sqrt((mat.astype(np.float64) ** 2).sum(axis=1))
        if not col:
            return float(out[0]), bool(valid[0])
        return out, valid

    def op_vec_as_text(self, e, cols, memo):
        from ..types.dtypes import vector_to_text
        v, m = self.eval(e.args[0], cols, memo)
        if isinstance(v, np.ndarray) and v.dtype == object:
            valid = np.array(_mask_arr(np, m, v), bool).copy()
            out = np.empty(len(v), object)
            for i, x in enumerate(v):
                if valid[i] and x is not None:
                    out[i] = vector_to_text(x)
                else:
                    out[i] = ""
                    valid[i] = False
            return out, valid
        return vector_to_text(np.asarray(v, np.float32).reshape(-1)), m

    # -- comparisons ----------------------------------------------------- #

    def _cmp(self, e, cols, memo, fn):
        xp = self.xp
        a, b = e.args
        if a.dtype.is_string and b.dtype.is_string:
            # post-lowering both sides are dict codes / code thresholds
            va, ma = self.eval(a, cols, memo)
            vb, mb = self.eval(b, cols, memo)
            return fn(va, vb), vand(ma, mb)
        if {a.dtype.kind, b.dtype.kind} == {K.INT64, K.UINT64}:
            # sign-aware signed-vs-unsigned compare: a negative signed value
            # orders below every unsigned value; otherwise compare in uint64.
            va, ma = self._num(a, cols, memo)
            vb, mb = self._num(b, cols, memo)
            ua = _as_u64(xp, va)
            ub = _as_u64(xp, vb)
            res = fn(ua, ub)
            if a.dtype.kind == K.INT64:
                res = xp.where(va < 0, fn(xp.int64(-1), xp.int64(0)), res)
            else:
                res = xp.where(vb < 0, fn(xp.int64(0), xp.int64(-1)), res)
            return res, vand(ma, mb)
        va, ma, vb, mb, _ = self._to_common(e, cols, memo)
        va, vb = self._cmp_fit(va, vb)
        return fn(va, vb), vand(ma, mb)

    def op_eq(self, e, cols, memo):
        return self._cmp(e, cols, memo, lambda a, b: a == b)

    def op_ne(self, e, cols, memo):
        return self._cmp(e, cols, memo, lambda a, b: a != b)

    def op_lt(self, e, cols, memo):
        return self._cmp(e, cols, memo, lambda a, b: a < b)

    def op_le(self, e, cols, memo):
        return self._cmp(e, cols, memo, lambda a, b: a <= b)

    def op_gt(self, e, cols, memo):
        return self._cmp(e, cols, memo, lambda a, b: a > b)

    def op_ge(self, e, cols, memo):
        return self._cmp(e, cols, memo, lambda a, b: a >= b)

    # -- sequences (host-only, side-effecting; never folded/cached) ------ #

    def _seq_conn(self):
        from ..planner.build import SESSION_INFO
        info = SESSION_INFO.get()
        return int(info.get("conn_id", 0)) if info else 0

    def _rows_n(self, cols) -> int:
        for v, _m in cols:
            if getattr(v, "ndim", 0):
                return len(v)
        return 1

    def op_seq_next(self, e, cols, memo):
        """NEXTVAL(seq): advances once per evaluated row (MySQL/TiDB
        row-at-a-time semantics)."""
        seq = e.args[0].value
        conn = self._seq_conn()
        n = self._rows_n(cols)
        vals = np.fromiter((seq.next_value(conn) for _ in range(n)),
                           np.int64, count=n)
        return (self.xp.asarray(vals) if n > 1 or cols else
                int(vals[0])), True

    def op_seq_last(self, e, cols, memo):
        seq = e.args[0].value
        v = seq.last_value(self._seq_conn())
        if v is None:
            return self.xp.int64(0), False
        return int(v), True

    def op_seq_set(self, e, cols, memo):
        seq = e.args[0].value
        v, m = self._num(e.args[1], cols, memo)
        if getattr(v, "ndim", 0) and np.asarray(v).size != 1:
            raise ValueError("SETVAL takes a constant value, "
                             "not a per-row expression")
        if m is not True and not (np.asarray(m).reshape(-1)[:1].all()
                                  if getattr(m, "ndim", 0) else bool(m)):
            return self.xp.int64(0), False
        val = int(v if not getattr(v, "ndim", 0) else np.asarray(v).item())
        out = seq.set_value(val, self._seq_conn())
        if out is None:          # ignored backwards move -> NULL
            return self.xp.int64(0), False
        return int(out), True

    # -- three-valued logic ---------------------------------------------- #

    def op_and(self, e, cols, memo):
        va, ma = self._truthy(e.args[0], cols, memo)
        vb, mb = self._truthy(e.args[1], cols, memo)
        val = va & vb
        if ma is True and mb is True:   # all-valid fast path (hot scans)
            return val, True
        # NULL AND FALSE = FALSE:  valid if both valid, or either side is a valid FALSE
        valid = _or3(vand(ma, mb), vand(ma, ~va), vand(mb, ~vb))
        return val, valid

    def op_or(self, e, cols, memo):
        va, ma = self._truthy(e.args[0], cols, memo)
        vb, mb = self._truthy(e.args[1], cols, memo)
        val = va | vb
        if ma is True and mb is True:
            return val, True
        valid = _or3(vand(ma, mb), vand(ma, va), vand(mb, vb))
        return val, valid

    def op_xor(self, e, cols, memo):
        va, ma = self._truthy(e.args[0], cols, memo)
        vb, mb = self._truthy(e.args[1], cols, memo)
        return va ^ vb, vand(ma, mb)

    def op_not(self, e, cols, memo):
        v, m = self._truthy(e.args[0], cols, memo)
        return ~v, m

    # -- NULL handling ---------------------------------------------------- #

    def op_isnull(self, e, cols, memo):
        v, m = self.eval(e.args[0], cols, memo)
        if m is True:
            return _broadcast_false(self.xp, v), True
        if m is False:
            return True, True
        return ~m, True

    def op_if(self, e, cols, memo):
        xp = self.xp
        c, cm = self._truthy(e.args[0], cols, memo)
        tv, tm = self._branch_val(e, e.args[1], cols, memo)
        ev, em = self._branch_val(e, e.args[2], cols, memo)
        cond = c if cm is True else (c & cm)  # NULL condition -> else branch
        val = xp.where(cond, tv, ev)
        valid = xp.where(cond, _mask_arr(xp, tm, tv), _mask_arr(xp, em, ev))
        return val, valid

    def op_case(self, e, cols, memo):
        xp = self.xp
        args = e.args
        has_else = len(args) % 2 == 1
        pairs = [(args[i], args[i + 1]) for i in range(0, len(args) - (1 if has_else else 0), 2)]
        if has_else:
            acc_val, acc_valid = self._branch_val(e, args[-1], cols, memo)
        else:
            acc_val, acc_valid = xp.int64(0), False
        # fold from last WHEN to first
        for c, v in reversed(pairs):
            cv, cm = self._truthy(c, cols, memo)
            cond = cv if cm is True else (cv & cm)
            bv, bm = self._branch_val(e, v, cols, memo)
            acc_val = xp.where(cond, bv, acc_val)
            acc_valid = xp.where(cond, _mask_arr(xp, bm, bv), _mask_arr(xp, acc_valid, acc_val))
        return acc_val, acc_valid

    def op_coalesce(self, e, cols, memo):
        xp = self.xp
        val, valid = self._branch_val(e, e.args[-1], cols, memo)
        for a in reversed(e.args[:-1]):
            av, am = self._branch_val(e, a, cols, memo)
            use_a = _mask_arr(xp, am, av)
            val = xp.where(use_a, av, val)
            valid = use_a | _mask_arr(xp, valid, val)
        return val, valid

    def _branch_val(self, parent: Func, a: Expr, cols, memo) -> Pair:
        """Evaluate a CASE/IF branch, coercing to the parent's result type."""
        v, m = self.eval(a, cols, memo)
        pk = parent.dtype.kind
        if getattr(v, "dtype", None) is not None and v.dtype == bool:
            v = v.astype(self.xp.int64)
        elif isinstance(v, bool):
            v = int(v)
        if pk in (K.FLOAT64, K.FLOAT32) and a.dtype.kind not in (K.FLOAT64, K.FLOAT32):
            v = self._as_double(v, a.dtype)
        elif pk == K.DECIMAL:
            sa = a.dtype.scale if a.dtype.kind == K.DECIMAL else 0
            if sa < parent.dtype.scale:
                v = self._iwiden("multiply", v,
                                 dec.pow10(parent.dtype.scale - sa), False)
        if pk in self._INT_FAMILY and self._is_narrow(v):
            # branches of one CASE/IF must share a width: a narrow branch
            # next to a wide/const branch would overflow xp.where promotion
            v = _as_i64(self.xp, v)
        return v, m

    # -- IN -------------------------------------------------------------- #

    def op_in(self, e, cols, memo):
        xp = self.xp
        target, items = e.args[0], e.args[1:]
        tv, tm = self._num(target, cols, memo) if target.dtype.is_numeric \
            else self.eval(target, cols, memo)
        any_match = None
        all_valid = tm
        for it in items:
            iv, im = self._num(it, cols, memo) if it.dtype.is_numeric \
                else self.eval(it, cols, memo)
            # unify decimal scales between target and item
            if target.dtype.kind == K.DECIMAL or it.dtype.kind == K.DECIMAL:
                st = target.dtype.scale if target.dtype.kind == K.DECIMAL else 0
                si = it.dtype.scale if it.dtype.kind == K.DECIMAL else 0
                s = max(st, si)
                a = self._iwiden("multiply", tv, dec.pow10(s - st), False) \
                    if st < s else tv
                b = self._iwiden("multiply", iv, dec.pow10(s - si), False) \
                    if si < s else iv
                a, b = self._cmp_fit(a, b)
                match = a == b
            else:
                a, b = self._cmp_fit(tv, iv)
                match = a == b
            if im is not True:  # NULL/invalid item can never be a match
                match = match & im
            any_match = match if any_match is None else (any_match | match)
            all_valid = vand(all_valid, im)
        # true if any valid match; null if no match and some operand null
        valid = _or3(all_valid, vand(tm, any_match), False)
        return any_match, valid

    # -- strings (post-lowering) ----------------------------------------- #

    def _op_string_unlowered(self, e, cols, memo):
        out = self._rowwise_string(e, cols, memo)
        if out is not None:
            return out
        raise NotImplementedError(
            f"string function {e.op.upper()} could not be lowered onto "
            "dictionary codes (non-dictionary input, non-constant "
            "arguments, or dictionary product too large)")

    def _str_rows(self, a, cols, memo) -> Optional[tuple]:
        """(list[str], validity) of a string-producing argument for the
        row-wise fallback: dict columns decode through their dictionary,
        host string producers (cast_char/date_format) pass object arrays
        through, constants broadcast.  None when the values can't be
        recovered (no dictionary available)."""
        if isinstance(a, Const):
            if a.value is None:
                return ["", False]
            if isinstance(a.value, str):
                return [a.value, True]
            return [str(a.value), True]
        d = None
        if isinstance(a, ColumnRef) and a.dtype.is_string:
            d = (self.dicts or {}).get(a.index)
            if d is None:
                return None
        else:
            d = getattr(a, "_derived_dict", None)
        v, m = self.eval(a, cols, memo)
        v = np.atleast_1d(np.asarray(v))
        if v.dtype == object:
            return [list(v), m]
        if d is not None:
            return [[d.decode(int(c)) for c in v], m]
        if not a.dtype.is_string:
            # numeric operand in a string context (CONCAT(n, 'x'))
            k = a.dtype.kind
            if k in (K.FLOAT64, K.FLOAT32):
                vals = []
                for x in v:
                    s = repr(float(x))
                    vals.append(s[:-2] if s.endswith(".0") else s)
            else:
                vals = [str(int(x)) for x in v]
            return [vals, m]
        return None

    def _rowwise_string(self, e, cols, memo):
        """Per-row host evaluation of a string function over recoverable
        string inputs (numpy only) — composes dict columns with host
        string producers where no single dictionary space exists."""
        if self.xp is not np:
            return None
        from .lower_strings import _str_valued_impl
        from .builders import STRING_INT_FUNCS, STRING_VALUED_FUNCS
        arows = [self._str_rows(a, cols, memo) for a in e.args]
        n = 1
        for r in arows:
            if r is not None and isinstance(r[0], list):
                n = max(n, len(r[0]))

        def row(r, i):
            if r is None:
                return None, False
            vals, m = r
            v = vals if isinstance(vals, str) else vals[i]
            if m is True:
                ok = True
            elif m is False:
                ok = False
            else:
                mm = np.atleast_1d(np.asarray(m))
                ok = bool(mm[i]) if len(mm) > 1 else bool(mm[0])
            return v, ok

        if e.op == "concat":
            if any(r is None for r in arows):
                return None
            out = np.empty(n, object)
            valid = np.ones(n, bool)
            for i in range(n):
                parts = []
                for r in arows:
                    v, ok = row(r, i)
                    if not ok:
                        valid[i] = False
                        break
                    parts.append(v)
                out[i] = "".join(parts) if valid[i] else ""
            return out, valid
        if e.op in STRING_VALUED_FUNCS or e.op in (
                "length", "char_length", "ascii", "bit_length",
                "inet_aton", "regexp_like", "regexp_instr",
                "json_depth", "json_contains_path", "json_storage_size",
                "json_overlaps", "is_uuid", "ord"):
            col_rows = arows[0]
            if col_rows is None:
                return None
            if isinstance(col_rows[0], str):    # folded constant operand
                col_rows = [[col_rows[0]] * n, col_rows[1]]
            consts = []
            for a in e.args[1:]:
                if not isinstance(a, Const) or a.value is None:
                    return None
                consts.append(a.value)
            if e.op == "length":
                fn = lambda v: len(v.encode("utf-8"))
            elif e.op == "char_length":
                fn = lambda v: len(v)
            elif e.op == "ascii":
                fn = lambda v: ord(v[0]) if v else 0
            elif e.op in ("bit_length", "inet_aton", "regexp_like",
                          "regexp_instr", "json_depth",
                          "json_contains_path", "json_storage_size",
                          "json_overlaps", "is_uuid", "ord"):
                from .lower_strings import _str_int_impl
                fn = _str_int_impl(e.op, consts)
            else:
                fn = _str_valued_impl(e.op, consts)
            if fn is None:
                return None
            int_out = e.op in STRING_INT_FUNCS
            out = np.zeros(n, np.int64) if int_out else np.empty(n, object)
            valid = np.ones(n, bool)
            for i in range(n):
                v, ok = row(col_rows, i)
                if not ok:
                    valid[i] = False
                    if not int_out:
                        out[i] = ""
                    continue
                r = fn(v)
                if r is None:
                    valid[i] = False
                    if not int_out:
                        out[i] = ""
                else:
                    out[i] = r
            return out, valid
        return None

    op_upper = op_lower = op_trim = op_ltrim = op_rtrim = \
        op_reverse = op_substring = op_replace = op_concat = op_left = \
        op_right = op_lpad = op_rpad = op_length = op_char_length = \
        op_ascii = op_locate = op_instr = op_find_in_set = \
        op_json_extract = op_json_unquote = op_json_type = \
        op_json_valid = op_json_length = op_json_contains = \
        op_insert_str = op_quote = op_to_base64 = op_from_base64 = \
        op_unhex = op_regexp_substr = op_regexp_replace = op_conv = \
        op_bit_length = op_inet_aton = op_regexp_like = \
        op_regexp_instr = op_str_to_date = \
        op_json_set = op_json_insert = op_json_replace = \
        op_json_remove = op_json_keys = op_json_search = \
        op_json_merge_patch = op_json_merge_preserve = op_json_merge = \
        op_json_array_append = op_json_pretty = op_json_quote = \
        op_json_value = op_json_depth = op_json_contains_path = \
        op_json_storage_size = op_json_overlaps = op_is_uuid = \
        op_ord = op_uuid_to_bin = op_bin_to_uuid = op_inet6_aton = \
        op_inet6_ntoa = op_compress = op_uncompress = \
        op_weight_string = \
        _op_string_unlowered

    def op_dict_lut(self, e, cols, memo):
        xp = self.xp
        cv, cm = self.eval(e.args[0], cols, memo)
        lut, _ = self.eval(e.args[1], cols, memo)
        codes = xp.clip(cv, 0, lut.shape[0] - 1)
        return lut[codes], cm

    # same clip+gather body: code translation reuses the LUT machinery
    op_dict_map = op_dict_lut

    # -- temporal --------------------------------------------------------- #

    def _days_of(self, a: Expr, cols, memo):
        from ..types.temporal import MICROS_PER_DAY
        v, m = self.eval(a, cols, memo)
        if a.dtype.kind == K.DATETIME:
            v = self.xp.floor_divide(v, MICROS_PER_DAY)
        return v, m

    def _ymd(self, a: Expr, cols, memo):
        from ..types.temporal import civil_from_days
        days, m = self._days_of(a, cols, memo)
        y, mo, d = civil_from_days(self.xp, days)
        return y, mo, d, m

    def op_year(self, e, cols, memo):
        y, _, _, m = self._ymd(e.args[0], cols, memo)
        return y, m

    def op_month(self, e, cols, memo):
        _, mo, _, m = self._ymd(e.args[0], cols, memo)
        return mo, m

    def op_dayofmonth(self, e, cols, memo):
        _, _, d, m = self._ymd(e.args[0], cols, memo)
        return d, m

    # -- math builtins ---------------------------------------------------- #

    def op_ceil(self, e, cols, memo):
        return self._ceil_floor(e, cols, memo, self.xp.ceil)

    def op_floor(self, e, cols, memo):
        return self._ceil_floor(e, cols, memo, self.xp.floor)

    def _ceil_floor(self, e, cols, memo, fn):
        xp = self.xp
        a = e.args[0]
        v, m = self._num(a, cols, memo)
        if a.dtype.is_float:
            return fn(self._as_double(v, a.dtype)), m
        if a.dtype.kind == K.DECIMAL:
            p = dec.pow10(a.dtype.scale)
            q = xp.floor_divide(v, p)
            if fn is xp.ceil:
                q = q + ((v - q * p) != 0)
            return _as_i64(xp, q), m
        return _as_i64(xp, v), m

    def op_round(self, e, cols, memo):
        return self._round_trunc(e, cols, memo, False)

    def op_truncate(self, e, cols, memo):
        return self._round_trunc(e, cols, memo, True)

    def _round_trunc(self, e, cols, memo, trunc: bool):
        xp = self.xp
        a, d = e.args
        nd = int(d.value)
        v, m = self._num(a, cols, memo)
        if a.dtype.is_float:
            f = self._as_double(v, a.dtype)
            p = 10.0 ** nd
            scaled = f * p
            if trunc:
                out = xp.trunc(scaled) / p
            else:
                out = xp.where(scaled >= 0, xp.floor(scaled + 0.5),
                               xp.ceil(scaled - 0.5)) / p
            return out, m
        if a.dtype.kind == K.DECIMAL:
            drop = a.dtype.scale - e.dtype.scale
            if drop > 0:
                p = dec.pow10(drop)
                v = _trunc_div(xp, v, xp.int64(p)) if trunc \
                    else _round_div(xp, v, xp.int64(p))
            if nd < 0:   # ROUND(dec, -k): also round off integer digits
                p2 = dec.pow10(-nd)
                v = (_trunc_div(xp, v, xp.int64(p2)) if trunc
                     else _round_div(xp, v, xp.int64(p2))) * p2
            return v, m
        if nd < 0:       # integer rounding to powers of ten
            p = dec.pow10(-nd)
            out = _trunc_div(xp, v, xp.int64(p)) if trunc \
                else _round_div(xp, v, xp.int64(p))
            return out * p, m
        return v, m

    def op_sign(self, e, cols, memo):
        v, m = self._num(e.args[0], cols, memo)
        return _as_i64(self.xp, self.xp.sign(v)), m

    def _double1(self, e, cols, memo):
        a = e.args[0]
        v, m = self._num(a, cols, memo)
        return self._as_double(v, a.dtype), m

    def op_sqrt(self, e, cols, memo):
        xp = self.xp
        v, m = self._double1(e, cols, memo)
        return xp.sqrt(xp.where(v < 0, 0.0, v)), vand(m, v >= 0)

    def op_exp(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return self.xp.exp(v), m

    def op_ln(self, e, cols, memo):
        xp = self.xp
        v, m = self._double1(e, cols, memo)
        return xp.log(xp.where(v <= 0, 1.0, v)), vand(m, v > 0)

    def op_log(self, e, cols, memo):
        xp = self.xp
        if len(e.args) == 1:
            return self.op_ln(e, cols, memo)
        # LOG(base, x)
        bv, bm = self._num(e.args[0], cols, memo)
        b = self._as_double(bv, e.args[0].dtype)
        xv, xm = self._num(e.args[1], cols, memo)
        x = self._as_double(xv, e.args[1].dtype)
        ok = (x > 0) & (b > 0) & (b != 1.0)
        num = xp.log(xp.where(x <= 0, 1.0, x))
        den = xp.log(xp.where((b <= 0) | (b == 1.0), 2.0, b))
        return num / den, vand(vand(bm, xm), ok)

    def op_log2(self, e, cols, memo):
        xp = self.xp
        v, m = self._double1(e, cols, memo)
        return xp.log2(xp.where(v <= 0, 1.0, v)), vand(m, v > 0)

    def op_log10(self, e, cols, memo):
        xp = self.xp
        v, m = self._double1(e, cols, memo)
        return xp.log10(xp.where(v <= 0, 1.0, v)), vand(m, v > 0)

    def op_pow(self, e, cols, memo):
        xp = self.xp
        bv, bm = self._num(e.args[0], cols, memo)
        ev_, em = self._num(e.args[1], cols, memo)
        b = self._as_double(bv, e.args[0].dtype)
        x = self._as_double(ev_, e.args[1].dtype)
        # negative base with fractional exponent -> NULL (MySQL: error/NaN)
        ok = (b >= 0) | (x == xp.floor(x))
        out = xp.power(xp.where(ok, b, 1.0), x)
        return out, vand(vand(bm, em), ok)

    def op_sin(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return self.xp.sin(v), m

    def op_cos(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return self.xp.cos(v), m

    def op_tan(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return self.xp.tan(v), m

    def op_cot(self, e, cols, memo):
        xp = self.xp
        v, m = self._double1(e, cols, memo)
        t = xp.tan(v)
        return 1.0 / xp.where(t == 0, 1.0, t), vand(m, t != 0)

    def op_asin(self, e, cols, memo):
        xp = self.xp
        v, m = self._double1(e, cols, memo)
        ok = (v >= -1) & (v <= 1)
        return xp.arcsin(xp.clip(v, -1, 1)), vand(m, ok)

    def op_acos(self, e, cols, memo):
        xp = self.xp
        v, m = self._double1(e, cols, memo)
        ok = (v >= -1) & (v <= 1)
        return xp.arccos(xp.clip(v, -1, 1)), vand(m, ok)

    def op_atan(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return self.xp.arctan(v), m

    def op_atan2(self, e, cols, memo):
        xp = self.xp
        av, am = self._num(e.args[0], cols, memo)
        bv, bm = self._num(e.args[1], cols, memo)
        return xp.arctan2(self._as_double(av, e.args[0].dtype),
                          self._as_double(bv, e.args[1].dtype)), vand(am, bm)

    def op_radians(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return v * (np.pi / 180.0), m

    def op_degrees(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return v * (180.0 / np.pi), m

    def _minmax_chain(self, e, cols, memo, fn):
        xp = self.xp
        if e.dtype.is_string and getattr(e, "_derived_dict", None) is None:
            raise NotImplementedError(
                f"{e.op.upper()} over strings requires dictionary-encoded "
                "columns (merged-code lowering did not apply)")
        val = valid = None
        for a in e.args:
            v, m = self._branch_val(e, a, cols, memo)
            if val is None:
                val, valid = v, m
            else:
                val = fn(val, v)
                valid = vand(valid, m)   # MySQL: NULL if any arg NULL
        return val, valid

    def op_greatest(self, e, cols, memo):
        return self._minmax_chain(e, cols, memo, self.xp.maximum)

    def op_least(self, e, cols, memo):
        return self._minmax_chain(e, cols, memo, self.xp.minimum)

    # -- temporal builtins ------------------------------------------------- #

    def op_dayofweek(self, e, cols, memo):
        # 1 = Sunday (ODBC); epoch day 0 = Thursday
        days, m = self._days_of(e.args[0], cols, memo)
        return _pymod(self.xp, days + 4, 7) + 1, m

    def op_weekday(self, e, cols, memo):
        # 0 = Monday
        days, m = self._days_of(e.args[0], cols, memo)
        return _pymod(self.xp, days + 3, 7), m

    def op_dayofyear(self, e, cols, memo):
        from ..types.temporal import civil_from_days, days_from_civil
        xp = self.xp
        days, m = self._days_of(e.args[0], cols, memo)
        days = _as_i64(xp, days)
        y, _, _ = civil_from_days(xp, days)
        jan1 = days_from_civil(xp, y, xp.ones_like(y), xp.ones_like(y))
        return days - jan1 + 1, m

    def op_quarter(self, e, cols, memo):
        _, mo, _, m = self._ymd(e.args[0], cols, memo)
        return (mo + 2) // 3, m

    def _time_part(self, e, cols, memo, div, mod):
        from ..types.temporal import MICROS_PER_DAY
        xp = self.xp
        a = e.args[0]
        v, m = self.eval(a, cols, memo)
        if a.dtype.kind == K.DATE:
            return xp.zeros_like(_as_i64(xp, v)), m
        tod = _pymod(xp, _as_i64(xp, v), MICROS_PER_DAY)
        return _pymod(xp, tod // div, mod), m

    def op_hour(self, e, cols, memo):
        return self._time_part(e, cols, memo, 3_600_000_000, 24)

    def op_minute(self, e, cols, memo):
        return self._time_part(e, cols, memo, 60_000_000, 60)

    def op_second(self, e, cols, memo):
        return self._time_part(e, cols, memo, 1_000_000, 60)

    def op_microsecond(self, e, cols, memo):
        return self._time_part(e, cols, memo, 1, 1_000_000)

    def op_datediff(self, e, cols, memo):
        da, ma = self._days_of(e.args[0], cols, memo)
        db, mb = self._days_of(e.args[1], cols, memo)
        return _as_i64(self.xp, da) - _as_i64(self.xp, db), vand(ma, mb)

    def op_dateadd_days(self, e, cols, memo):
        from ..types.temporal import MICROS_PER_DAY
        a, n = e.args
        v, m = self.eval(a, cols, memo)
        nv, nm = self._num(n, cols, memo)
        step = MICROS_PER_DAY if a.dtype.kind == K.DATETIME else 1
        return _as_i64(self.xp, v) + _as_i64(self.xp, nv) * step, vand(m, nm)

    def op_dateadd_months(self, e, cols, memo):
        from ..types.temporal import (MICROS_PER_DAY, civil_from_days,
                                      days_from_civil, days_in_month)
        xp = self.xp
        a, n = e.args
        v, m = self.eval(a, cols, memo)
        nv, nm = self._num(n, cols, memo)
        v = _as_i64(xp, v)
        is_dt = a.dtype.kind == K.DATETIME
        days = xp.floor_divide(v, MICROS_PER_DAY) if is_dt else v
        tod = v - days * MICROS_PER_DAY if is_dt else 0
        y, mo, d = civil_from_days(xp, days)
        mi = y * 12 + (mo - 1) + _as_i64(xp, nv)
        y2 = xp.floor_divide(mi, 12)
        mo2 = mi - y2 * 12 + 1
        d2 = xp.minimum(d, days_in_month(xp, y2, mo2))
        out_days = days_from_civil(xp, y2, mo2, d2)
        out = out_days * MICROS_PER_DAY + tod if is_dt else out_days
        return out, vand(m, nm)

    def op_dateadd_micros(self, e, cols, memo):
        a, n = e.args
        v, m = self.eval(a, cols, memo)
        nv, nm = self._num(n, cols, memo)
        return _as_i64(self.xp, v) + _as_i64(self.xp, nv), vand(m, nm)

    def op_last_day(self, e, cols, memo):
        from ..types.temporal import days_from_civil, days_in_month
        xp = self.xp
        y, mo, _d, m = self._ymd(e.args[0], cols, memo)
        return days_from_civil(xp, y, mo, days_in_month(xp, y, mo)), m

    def op_to_days(self, e, cols, memo):
        # MySQL TO_DAYS: days since year 0 (epoch 1970-01-01 = 719528)
        days, m = self._days_of(e.args[0], cols, memo)
        return _as_i64(self.xp, days) + 719528, m

    def op_from_days(self, e, cols, memo):
        v, m = self._num(e.args[0], cols, memo)
        return _as_i64(self.xp, v) - 719528, m

    def op_week(self, e, cols, memo):
        """WEEK(d[, mode]): mode 0 (MySQL default, Sunday-start, week 1 =
        first week containing a Sunday) and mode 3 (ISO 8601, Monday-
        start) — builtin_time.go weekMode subset, vectorized over the
        civil-date math."""
        from ..types.temporal import civil_from_days, days_from_civil
        xp = self.xp
        days, m = self._days_of(e.args[0], cols, memo)
        days = _as_i64(xp, days)
        mode = int(e.args[1].value) if len(e.args) > 1 else 0
        if mode == 3:
            # the ISO week of d is the week of d's Thursday
            thursday = days - (days + 3) % 7 + 3
            y, _, _ = civil_from_days(xp, thursday)
            j = days_from_civil(xp, y, 1, 1)
            return (thursday - j) // 7 + 1, m
        y, _, _ = civil_from_days(xp, days)
        j = days_from_civil(xp, y, 1, 1)
        fs = j + (7 - (j + 4) % 7) % 7       # first Sunday of the year
        return xp.maximum(xp.floor_divide(days - fs, 7) + 1, 0), m

    def op_from_unixtime(self, e, cols, memo):
        from ..types.temporal import MICROS_PER_SEC
        v, m = self._num(e.args[0], cols, memo)
        a = e.args[0]
        if a.dtype.kind == K.DECIMAL:
            from ..types import decimal as dec
            micros = _as_i64(self.xp, v) * (
                MICROS_PER_SEC // dec.pow10(min(a.dtype.scale, 6)))
        else:
            micros = _as_i64(self.xp, v) * MICROS_PER_SEC
        return micros, m

    def op_makedate(self, e, cols, memo):
        """MAKEDATE(year, dayofyear) -> DATE; NULL when dayofyear < 1."""
        from ..types.temporal import days_from_civil
        xp = self.xp
        y, my = self._num(e.args[0], cols, memo)
        doy, md = self._num(e.args[1], cols, memo)
        y = _as_i64(xp, y)
        doy = _as_i64(xp, doy)
        j = days_from_civil(xp, y, 1, 1)
        out = j + doy - 1
        ok = doy >= 1
        return out, vand(vand(my, md), ok)

    # -- host string-producing builtins ------------------------------- #
    # These yield python-str object arrays; they are NOT in DEVICE_OPS,
    # so plans keep them in host root executors where _eval_to_column
    # dictionary-encodes the produced values (the residual-evaluation
    # half of the pushdown contract, SURVEY.md §A.1).

    def op_cast_char(self, e, cols, memo):
        """CAST(x AS CHAR[(n)]) for non-string x — per-row host string
        production, dictionary-encoded by the host projection
        (builtin_cast.go castAsStringSig).  String sources lower in
        lower_strings and never reach this op."""
        from ..types import temporal as tmp
        a = e.args[0]
        v, m = self.eval(a, cols, memo)
        v = np.atleast_1d(np.asarray(v))
        kind = a.dtype.kind
        out = np.empty(len(v), object)
        for i in range(len(v)):
            x = v[i]
            if kind == K.DECIMAL:
                s = dec.to_string(int(x), a.dtype.scale)
            elif kind == K.DATE:
                s = tmp.date_to_string(int(x))
            elif kind == K.DATETIME:
                s = tmp.datetime_to_string(int(x))
            elif kind in (K.FLOAT64, K.FLOAT32):
                s = repr(float(x))
                if s.endswith(".0"):
                    s = s[:-2]
                s = s.replace("e+", "e")
            elif kind == K.ENUM:
                ix = int(x)
                s = (a.dtype.members[ix - 1]
                     if 1 <= ix <= len(a.dtype.members) else "")
            elif kind == K.UINT64:
                s = str(int(np.uint64(np.int64(x))))
            else:
                s = str(int(x))
            out[i] = s
        n = getattr(e, "_char_len", None)
        if n is not None:
            out = np.array([s[:n] for s in out], object)
        return out, m

    def op_date_format(self, e, cols, memo):
        """DATE_FORMAT(d, fmt) — the common MySQL specifiers
        (builtin_time.go dateFormat subset)."""
        from ..types.temporal import MICROS_PER_DAY, civil_from_days
        xp = self.xp
        v, m = self.eval(e.args[0], cols, memo)
        fmt = str(e.args[1].value)
        v = np.asarray(v)
        if e.args[0].dtype.kind == K.DATETIME:
            days = v // MICROS_PER_DAY
            micros = v - days * MICROS_PER_DAY
        else:
            days = v
            micros = np.zeros_like(np.asarray(days))
        days = np.atleast_1d(np.asarray(days)).astype(np.int64)
        micros = np.atleast_1d(np.asarray(micros)).astype(np.int64)
        y, mo, d = civil_from_days(np, days)
        wd = (days + 3) % 7                      # 0 = Monday
        doy = days - _jan1(np, y) + 1
        hh = micros // 3_600_000_000
        mi = micros // 60_000_000 % 60
        ss = micros // 1_000_000 % 60
        day_names = ["Monday", "Tuesday", "Wednesday", "Thursday",
                     "Friday", "Saturday", "Sunday"]
        mon_names = ["January", "February", "March", "April", "May",
                     "June", "July", "August", "September", "October",
                     "November", "December"]
        out = np.empty(len(days), object)
        for i in range(len(days)):
            parts = []
            j = 0
            while j < len(fmt):
                c = fmt[j]
                if c != "%" or j + 1 >= len(fmt):
                    parts.append(c)
                    j += 1
                    continue
                sp = fmt[j + 1]
                j += 2
                yy, mm, dd = int(y[i]), int(mo[i]), int(d[i])
                rep = {
                    "Y": f"{yy:04d}", "y": f"{yy % 100:02d}",
                    "m": f"{mm:02d}", "c": str(mm),
                    "d": f"{dd:02d}", "e": str(dd),
                    "M": mon_names[mm - 1], "b": mon_names[mm - 1][:3],
                    "W": day_names[int(wd[i])],
                    "a": day_names[int(wd[i])][:3],
                    "j": f"{int(doy[i]):03d}",
                    "H": f"{int(hh[i]):02d}", "k": str(int(hh[i])),
                    "h": f"{(int(hh[i]) % 12) or 12:02d}",
                    "i": f"{int(mi[i]):02d}", "s": f"{int(ss[i]):02d}",
                    "S": f"{int(ss[i]):02d}",
                    "p": "AM" if int(hh[i]) < 12 else "PM",
                    "T": f"{int(hh[i]):02d}:{int(mi[i]):02d}"
                         f":{int(ss[i]):02d}",
                    "%": "%",
                }.get(sp)
                parts.append(rep if rep is not None else sp)
            out[i] = "".join(parts)
        return out, m

    def op_int_to_base(self, e, cols, memo):
        """BIN/OCT/HEX over integers: args = (value, base-const)."""
        v, m = self._num(e.args[0], cols, memo)
        base = int(e.args[1].value)
        arr = np.atleast_1d(_as_i64(self.xp, v))
        fmt = {2: "b", 8: "o", 16: "X"}[base]
        out = np.array([format(int(x) & 0xFFFFFFFFFFFFFFFF, fmt)
                        for x in arr], object)
        return out, m

    def op_uuid(self, e, cols, memo):
        """UUID(): fresh value PER ROW (host string producer; plans
        carrying it are tainted out of the plan cache)."""
        import uuid as _uuid
        n = len(cols[0][0]) if cols else 1
        out = np.array([str(_uuid.uuid4()) for _ in range(n)], object)
        return out, True

    def op_rand(self, e, cols, memo):
        """RAND([seed]): per-row uniform [0,1); seeded form is a
        deterministic sequence (builtin_math.go randSig)."""
        n = len(cols[0][0]) if cols else 1
        if e.args:
            rng = np.random.default_rng(int(e.args[0].value))
        else:
            rng = np.random.default_rng()
        return self.xp.asarray(rng.random(n)), True

    def op_inet_ntoa(self, e, cols, memo):
        """INET_NTOA(n) -> dotted-quad string (host string producer;
        builtin_miscellaneous.go inetNtoa)."""
        v, m = self._num(e.args[0], cols, memo)
        arr = np.atleast_1d(_as_i64(self.xp, v))
        out = np.empty(len(arr), object)
        ok = np.ones(len(arr), bool)
        for i, x in enumerate(arr):
            x = int(x)
            if 0 <= x <= 0xFFFFFFFF:
                out[i] = ".".join(str(x >> s & 255)
                                  for s in (24, 16, 8, 0))
            else:
                out[i] = ""
                ok[i] = False
        return out, vand(m, True if ok.all() else ok)

    def op_format_num(self, e, cols, memo):
        """FORMAT(n, d): thousands separators + d decimals."""
        v, m = self._num(e.args[0], cols, memo)
        d = max(int(e.args[1].value), 0)
        a0 = e.args[0]
        if a0.dtype.kind == K.DECIMAL:
            vals = [int(x) / dec.pow10(a0.dtype.scale)
                    for x in np.atleast_1d(np.asarray(v))]
        else:
            vals = [float(x) for x in np.atleast_1d(np.asarray(v))]
        out = np.array([f"{x:,.{d}f}" for x in vals], object)
        return out, m

    def op_unix_timestamp(self, e, cols, memo):
        from ..types.temporal import MICROS_PER_DAY, MICROS_PER_SEC
        xp = self.xp
        a = e.args[0]
        v, m = self.eval(a, cols, memo)
        v = _as_i64(xp, v)
        if a.dtype.kind == K.DATE:
            v = v * MICROS_PER_DAY
        return xp.floor_divide(v, MICROS_PER_SEC), m

    # -- casts ------------------------------------------------------------ #

    def op_cast(self, e, cols, memo):
        xp = self.xp
        a = e.args[0]
        src, dst = a.dtype, e.dtype
        if src.is_string or dst.is_string:
            # string casts must have been lowered onto dictionary codes
            # (lower_strings._lower_cast_strings) or routed to cast_char;
            # evaluating here would cast raw dict CODES
            raise NotImplementedError(f"unlowered string cast {src} -> {dst}")
        v, m = self._num(a, cols, memo)
        if dst.kind in (K.FLOAT64, K.FLOAT32):
            out = self._as_double(v, src)
            if dst.kind == K.FLOAT32 and hasattr(out, "astype"):
                out = out.astype(xp.float32)
            return out, m
        if dst.kind == K.DECIMAL:
            wide = dst.is_wide_decimal or src.is_wide_decimal
            if src.kind == K.DECIMAL:
                ds = dst.scale - src.scale
                if wide:
                    vo = _to_object(v)
                    out = (vo * dec.pow10(ds) if ds >= 0
                           else _round_div(np, vo, dec.pow10(-ds)))
                    return _dec_fit(out, m, dst), m
                if ds >= 0:
                    return self._iwiden("multiply", v,
                                        dec.pow10(ds), False), m
                return _round_div(xp, v, dec.pow10(-ds)), m
            if src.is_float:
                scaled = v * float(dec.pow10(dst.scale))
                out = xp.where(scaled >= 0, xp.floor(scaled + 0.5),
                               xp.ceil(scaled - 0.5))
                if dst.is_wide_decimal:
                    # python-int object lanes, exact for the float's value
                    vals = np.asarray(out, np.float64).reshape(-1)
                    obj = np.array([int(x) for x in vals], dtype=object)
                    return _dec_fit(obj, m, dst), m
                return out.astype(xp.int64), m
            if dst.is_wide_decimal:
                return _dec_fit(_to_object(v) * dec.pow10(dst.scale),
                                m, dst), m
            return self._iwiden("multiply", v,
                                dec.pow10(dst.scale), False), m
        if dst.kind in (K.INT64, K.UINT64):
            ity = xp.int64 if dst.kind == K.INT64 else xp.uint64
            if src.kind == K.DECIMAL:
                if src.is_wide_decimal:
                    out = _round_div(np, _to_object(v),
                                     dec.pow10(src.scale))
                    _int_fit(out, m, dst.kind == K.UINT64)
                    return out.astype(np.int64 if dst.kind == K.INT64
                                      else np.uint64), m
                out = _round_div(xp, v, dec.pow10(src.scale))
                return (out.astype(ity) if hasattr(out, "astype") else out), m
            if src.is_float:
                out = xp.where(v >= 0, xp.floor(v + 0.5), xp.ceil(v - 0.5))
                return out.astype(ity), m
            return (v.astype(ity) if hasattr(v, "astype") else int(v)), m
        if dst.kind == K.DATETIME and src.kind == K.DATE:
            from ..types.temporal import MICROS_PER_DAY
            return _as_i64(xp, v) * MICROS_PER_DAY, m
        if dst.kind == K.DATE and src.kind == K.DATETIME:
            from ..types.temporal import MICROS_PER_DAY
            return xp.floor_divide(_as_i64(xp, v), MICROS_PER_DAY), m
        if dst.kind == K.DATETIME and src.kind in (K.INT64, K.UINT64):
            # MySQL numeric->DATETIME: digits read as [YYYYMMDD]HHMMSS
            # (internal micros arithmetic uses the reinterp op instead)
            iv = _as_i64(xp, v)
            # date-only digits scale to [YYYYMMDD]000000; zero the other
            # lane BEFORE the multiply — 14-digit inputs times 10^6 wrap
            # int64 in the discarded lane otherwise
            date_only = iv < 10 ** 8
            iv = xp.where(date_only, iv, 0) * 10 ** 6 \
                + xp.where(date_only, 0, iv)
            y = iv // 10 ** 10
            mo = iv // 10 ** 8 % 100
            d = iv // 10 ** 6 % 100
            h = iv // 10 ** 4 % 100
            mi = iv // 100 % 100
            sec = iv % 100
            ok = ((mo >= 1) & (mo <= 12) & (d >= 1) & (d <= 31)
                  & (h < 24) & (mi < 60) & (sec < 60))
            from ..types.temporal import civil_from_days, days_from_civil
            days = days_from_civil(xp, y, mo, d)
            # calendar validation: Feb 31 etc. must be NULL, not rolled
            y2, m2, d2 = civil_from_days(xp, days)
            ok = ok & (y2 == y) & (m2 == mo) & (d2 == d)
            micros = (days * 86_400 + h * 3600 + mi * 60 + sec) * 1_000_000
            mm = ok if m is True else _mask_arr(xp, m, micros) & ok
            return xp.where(ok, micros, 0), mm
        if dst.kind == K.TIME and src.kind in (K.INT64, K.UINT64):
            # MySQL numeric->TIME: digits read as [H]HMMSS
            iv = _as_i64(xp, v)
            neg = iv < 0
            av2 = xp.abs(iv)
            h = av2 // 10 ** 4
            mi = av2 // 100 % 100
            sec = av2 % 100
            ok = (mi < 60) & (sec < 60)
            us = (h * 3600 + mi * 60 + sec) * 1_000_000
            us = xp.where(neg, -us, us)
            mm = ok if m is True else _mask_arr(xp, m, us) & ok
            return xp.where(ok, us, 0), mm
        if dst.kind == K.TIME and src.kind == K.DATETIME:
            # time-of-day component (MySQL CAST(datetime AS TIME))
            from ..types.temporal import MICROS_PER_DAY
            return _as_i64(xp, v) % MICROS_PER_DAY, m
        if dst.kind == src.kind:
            return _as_i64(xp, v), m
        raise NotImplementedError(f"cast {src} -> {dst}")

    def op_reinterp(self, e, cols, memo):
        """Raw int64-micros reinterpret between numeric and temporal —
        the INTERNAL seam SEC_TO_TIME/MAKETIME/ADDTIME/TIMEDIFF compose
        through (user CASTs parse digits instead)."""
        v, m = self.eval(e.args[0], cols, memo)
        return _as_i64(self.xp, v), m


# ---------------------------------------------------------------------- #

def _to_object(v):
    """Numeric value(s) as python-int object array/scalar (exact wide-
    decimal representation; host only)."""
    if hasattr(v, "astype"):
        return v.astype(object)
    return int(v)


def _dec_fit(data, m, dst):
    """ER_DATA_OUT_OF_RANGE when a decimal result exceeds its declared
    precision (mydecimal.go overflow; strict-mode semantics)."""
    bound = dec.pow10(dst.prec if dst.prec > 0 else 65)
    vals = data if m is True else (data[np.asarray(m)]
                                   if hasattr(data, "__getitem__") else data)
    arr = np.asarray(vals, dtype=object).reshape(-1)
    if len(arr) and (max(arr.max(), -arr.min())) >= bound:
        raise ValueError(
            f"Out of range value for DECIMAL({dst.prec},{dst.scale})")
    return data


def _int_fit(data, m, unsigned: bool):
    lo, hi = (0, 2 ** 64 - 1) if unsigned else (-2 ** 63, 2 ** 63 - 1)
    vals = data if m is True else data[np.asarray(m)]
    arr = np.asarray(vals, dtype=object).reshape(-1)
    if len(arr) and (int(arr.min()) < lo or int(arr.max()) > hi):
        raise ValueError("Out of range value for BIGINT"
                         + (" UNSIGNED" if unsigned else ""))


def _or3(a, b, c):
    if a is True:
        return True
    out = a
    for x in (b, c):
        if x is True:
            return True
        if x is False:
            continue
        out = x if out is False else (out | x)
    return out


def _mask_arr(xp, m, like):
    """Validity as an array broadcastable with `like`."""
    if m is True:
        return _broadcast_true(xp, like)
    if m is False:
        return _broadcast_false(xp, like)
    return m


def _as_i64(xp, v):
    return v.astype(xp.int64) if hasattr(v, "astype") else xp.int64(v)


def _pymod(xp, a, b):
    """Floor (python-style, non-negative for positive divisor) modulo —
    keeps calendar arithmetic correct for pre-epoch dates."""
    return xp.mod(a, b)


def _as_u64(xp, v):
    return v.astype(xp.uint64) if hasattr(v, "astype") else xp.uint64(v)


def _broadcast_true(xp, like):
    if hasattr(like, "shape") and like.shape:
        return xp.ones(like.shape, dtype=bool)
    return True


def _broadcast_false(xp, like):
    if hasattr(like, "shape") and like.shape:
        return xp.zeros(like.shape, dtype=bool)
    return False


def _trunc_div(xp, a, b):
    """Integer division truncating toward zero (MySQL DIV), div-by-0-safe."""
    safe = xp.where(b == 0, 1, b)
    q = xp.floor_divide(xp.abs(a), xp.abs(safe))
    sign = xp.where((a < 0) != (safe < 0), -1, 1)
    return sign * q


def _round_div(xp, a, b):
    """Integer division rounding half away from zero (MySQL decimal div)."""
    safe = xp.where(b == 0, 1, b)
    absb = xp.abs(safe)
    q = xp.floor_divide(xp.abs(a) + absb // 2, absb)
    sign = xp.where((a < 0) != (safe < 0), -1, 1)
    return sign * q


def _div_valid(xp, ma, mb, vb):
    nz = vb != 0
    return vand(vand(ma, mb), nz)


def eval_expr(xp, e: Expr, cols: Sequence[Pair], dicts=None) -> Pair:
    if xp is not np:
        raise TypeError("the host evaluator runs on numpy only; the "
                        "device lanes are expr/compile.py's Evaluator")
    return Evaluator(xp, dicts).eval(e, cols, {})


__all__ = ["Evaluator", "eval_expr", "vand"]
