# ported from tidb_tpu/expr/compile.py @ a9e9482
"""Expression evaluator with MySQL NULL + decimal semantics, on torch.

Every node evaluates to a pair ``(value, valid)``:

- value: a tensor in device representation (scaled ints for DECIMAL,
  dict codes for STRING, days for DATE), or a python scalar for a
  constant; comparisons and logic yield bool tensors;
- valid: a bool tensor, or the literal ``True`` meaning "all valid", or
  ``False`` for a NULL constant.

This is the subset the ported paths need: column refs, constants, the
six comparisons with decimal scale alignment and DOUBLE operands,
AND / OR / NOT with three-valued logic, IS NULL, ``+ - *`` and unary
minus / ABS with MySQL decimal scales, IN, and IF / CASE / COALESCE.
Other operators raise ``NotImplementedError``; they arrive with later
slices of the port (ROADMAP.md, Queue 1).

Narrow physical columns: scans hand the evaluator int8/int16/int32
tensors holding int64/decimal/date logical values.  torch keeps the
narrow width through arithmetic and wraps (``int16 * 4`` stays int16;
``100 - int8`` stays int8), so every integer-family result over a narrow
operand computes at int64 (``_iwiden``).  A comparison against a python
int runs at the narrow width only when the int fits it: torch casts an
out-of-range python scalar (or 0-d tensor) to the tensor's dtype and
wraps silently (``int16 < 100000`` is False), so ``_cmp_fit`` widens the
tensor side instead.

The JAX package guards decimal overflow on its host (numpy) lanes only;
its device lanes are unguarded, and so are the port's, on the CPU and on
the card alike.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..types import decimal as dec
from ..types import dtypes as dt
from .. import EVALUATOR, unported
from .ir import ColumnRef, Const, Expr, Func

K = dt.TypeKind

Pair = tuple[Any, Any]  # (value, valid)

_NARROW_INTS = (torch.int8, torch.int16, torch.int32, torch.uint8)
_INT_DTYPES = _NARROW_INTS + (torch.int64,)
_I64_MIN, _I64_MAX = -2 ** 63, 2 ** 63 - 1


def _unported(what: str) -> NotImplementedError:
    return unported(what, EVALUATOR)


def vand(a, b):
    if a is True:
        return b
    if b is True:
        return a
    return a & b


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


def _is_tensor(v) -> bool:
    return isinstance(v, torch.Tensor)


def _lane(v, device) -> torch.Tensor:
    """A value as a tensor for ``torch.where``: a python scalar becomes a
    0-d tensor of the JAX package's x64 dtype (bool, int64, float64);
    torch would make a python float float32."""
    if _is_tensor(v):
        return v
    if isinstance(v, (bool, np.bool_)):
        return torch.tensor(bool(v), device=device)
    if isinstance(v, (int, np.integer)):
        return torch.tensor(int(v), dtype=torch.int64, device=device)
    return torch.tensor(float(v), dtype=torch.float64, device=device)


def _mask_arr(m, like):
    """Validity as a value broadcastable with ``like``."""
    if (m is True or m is False) and _is_tensor(like) and like.dim():
        return torch.full(like.shape, m, dtype=torch.bool,
                          device=like.device)
    return m


def _as_i64(v):
    return v.to(torch.int64) if _is_tensor(v) else int(v)


class Evaluator:
    """Evaluate IR over columns of torch tensors on one device."""

    def __init__(self, device):
        self.device = torch.device(device)

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
                return 0, False
            if isinstance(e.value, (str, np.ndarray)):
                raise _unported("string and array constants")
            return e.value, True
        if not isinstance(e, Func):
            raise TypeError(f"not an expression: {e!r}")
        fn = getattr(self, f"op_{e.op}", None)
        if fn is None:
            raise _unported(f"op {e.op}")
        return fn(e, cols, memo)

    # -- helpers --------------------------------------------------------- #

    def _num(self, a: Expr, cols, memo):
        """Evaluate a numeric operand; cast bool compare-results to int."""
        v, m = self.eval(a, cols, memo)
        if _is_tensor(v) and v.dtype == torch.bool:
            v = v.to(torch.int64)
        elif isinstance(v, bool):
            v = int(v)
        return v, m

    @staticmethod
    def _iwiden(op: str, va, vb, unsigned: bool = False):
        """Integer add/sub/mul at the full int64 width whatever the
        physical width of a tensor operand; python scalars keep exact
        python arithmetic."""
        if not _is_tensor(va) and not _is_tensor(vb):
            return {"add": lambda: va + vb, "subtract": lambda: va - vb,
                    "multiply": lambda: va * vb}[op]()
        if unsigned:
            raise _unported("BIGINT UNSIGNED arithmetic")
        if _is_tensor(va) and va.dtype != torch.int64:
            va = va.to(torch.int64)
        if _is_tensor(vb) and vb.dtype != torch.int64:
            vb = vb.to(torch.int64)
        return {"add": torch.add, "subtract": torch.sub,
                "multiply": torch.mul}[op](va, vb)

    @staticmethod
    def _is_narrow(v) -> bool:
        return _is_tensor(v) and v.dtype in _NARROW_INTS

    @staticmethod
    def _cmp_fit(va, vb):
        """Make a comparison width-safe: a python int that fits a narrow
        tensor's dtype is compared at that width; otherwise every integer
        tensor side widens to int64 (torch would wrap the scalar)."""
        for x, y in ((va, vb), (vb, va)):
            if isinstance(y, (int, np.integer)) and not isinstance(y, bool):
                if not _I64_MIN <= int(y) <= _I64_MAX:
                    raise _unported("comparisons against wide decimals")
                if _is_tensor(x) and x.dtype in _NARROW_INTS:
                    info = torch.iinfo(x.dtype)
                    if info.min <= int(y) <= info.max:
                        return va, vb
        if _is_tensor(va) and _is_tensor(vb) and va.dtype == vb.dtype:
            return va, vb

        def widen(v):
            if _is_tensor(v) and v.dtype in _NARROW_INTS:
                return v.to(torch.int64)
            return v
        return widen(va), widen(vb)

    def _to_common(self, e: Func, cols, memo):
        """Evaluate both operands and unify numeric representation."""
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
                va = self._iwiden("multiply", va, dec.pow10(s - sa))
            if sb < s:
                vb = self._iwiden("multiply", vb, dec.pow10(s - sb))
            return va, ma, vb, mb, dt.decimal(18, s)
        if {ka, kb} == {K.DATE, K.DATETIME}:
            raise _unported("DATE against DATETIME comparisons")
        if K.UINT64 in (ka, kb):
            raise _unported("BIGINT UNSIGNED arithmetic and comparisons")
        return va, ma, vb, mb, (a.dtype if ka != K.NULL else b.dtype)

    @staticmethod
    def _as_double(v, t: dt.DataType):
        if t.kind == K.DECIMAL:
            return v.to(torch.float64) / float(dec.pow10(t.scale)) \
                if _is_tensor(v) else float(v) / dec.pow10(t.scale)
        if _is_tensor(v):
            return v.to(torch.float64)
        return float(v)

    def _truthy(self, e: Expr, cols, memo) -> Pair:
        """MySQL truthiness: nonzero numeric = true.  A scalar becomes a
        0-d bool tensor so ``~`` and ``&`` keep boolean semantics."""
        v, m = self.eval(e, cols, memo)
        if _is_tensor(v):
            return (v if v.dtype == torch.bool else v != 0), m
        return torch.tensor(v != 0, device=self.device), m

    # -- arithmetic ------------------------------------------------------ #

    _INT_FAMILY = (K.INT64, K.UINT64, K.DECIMAL, K.DATE, K.DATETIME,
                   K.TIME)

    def _arith(self, op: str, va, vb, t):
        """Add/sub/mul honoring the logical (int64) width when a physical
        operand is narrow."""
        if t.kind in self._INT_FAMILY and (self._is_narrow(va)
                                           or self._is_narrow(vb)):
            return self._iwiden(op, va, vb, t.kind == K.UINT64)
        return {"add": lambda: va + vb, "subtract": lambda: va - vb,
                "multiply": lambda: va * vb}[op]()

    def op_add(self, e, cols, memo):
        va, ma, vb, mb, t = self._to_common(e, cols, memo)
        return self._arith("add", va, vb, t), vand(ma, mb)

    def op_sub(self, e, cols, memo):
        va, ma, vb, mb, t = self._to_common(e, cols, memo)
        return self._arith("subtract", va, vb, t), vand(ma, mb)

    def op_mul(self, e, cols, memo):
        a, b = e.args
        if e.dtype.kind == K.DECIMAL:
            # scales add: no rescale needed before the integer multiply
            va, ma = self._num(a, cols, memo)
            vb, mb = self._num(b, cols, memo)
            return self._arith("multiply", va, vb, e.dtype), vand(ma, mb)
        va, ma, vb, mb, t = self._to_common(e, cols, memo)
        return self._arith("multiply", va, vb, t), vand(ma, mb)

    def op_neg(self, e, cols, memo):
        v, m = self._num(e.args[0], cols, memo)
        if self._is_narrow(v):
            v = _as_i64(v)             # -(INT_MIN of the narrow width)
        return -v, m

    def op_abs(self, e, cols, memo):
        v, m = self._num(e.args[0], cols, memo)
        if self._is_narrow(v):
            v = _as_i64(v)
        return (torch.abs(v) if _is_tensor(v) else abs(v)), m

    # -- comparisons ----------------------------------------------------- #

    def _cmp(self, e, cols, memo, fn):
        a, b = e.args
        if a.dtype.is_string and b.dtype.is_string:
            # both sides are dict codes / code thresholds
            va, ma = self.eval(a, cols, memo)
            vb, mb = self.eval(b, cols, memo)
            va, vb = self._cmp_fit(va, vb)
            return fn(va, vb), vand(ma, mb)
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

    # -- three-valued logic ---------------------------------------------- #

    def op_and(self, e, cols, memo):
        va, ma = self._truthy(e.args[0], cols, memo)
        vb, mb = self._truthy(e.args[1], cols, memo)
        val = va & vb
        if ma is True and mb is True:
            return val, True
        # NULL AND FALSE = FALSE: valid if both valid, or either side is
        # a valid FALSE
        return val, _or3(vand(ma, mb), vand(ma, ~va), vand(mb, ~vb))

    def op_or(self, e, cols, memo):
        va, ma = self._truthy(e.args[0], cols, memo)
        vb, mb = self._truthy(e.args[1], cols, memo)
        val = va | vb
        if ma is True and mb is True:
            return val, True
        return val, _or3(vand(ma, mb), vand(ma, va), vand(mb, vb))

    def op_not(self, e, cols, memo):
        v, m = self._truthy(e.args[0], cols, memo)
        return ~v, m

    # -- NULL handling ---------------------------------------------------- #

    def op_isnull(self, e, cols, memo):
        v, m = self.eval(e.args[0], cols, memo)
        if m is True:
            if _is_tensor(v) and v.dim():
                return torch.zeros(v.shape, dtype=torch.bool,
                                   device=v.device), True
            return False, True
        if m is False:
            return True, True
        return ~m, True

    # -- IF / CASE / COALESCE -------------------------------------------- #

    def _where(self, cond, a, b):
        return torch.where(_lane(cond, self.device), _lane(a, self.device),
                           _lane(b, self.device))

    def op_if(self, e, cols, memo):
        c, cm = self._truthy(e.args[0], cols, memo)
        tv, tm = self._branch_val(e, e.args[1], cols, memo)
        ev, em = self._branch_val(e, e.args[2], cols, memo)
        cond = c if cm is True else (c & cm)  # NULL condition -> else
        val = self._where(cond, tv, ev)
        valid = self._where(cond, _mask_arr(tm, tv), _mask_arr(em, ev))
        return val, valid

    def op_case(self, e, cols, memo):
        args = e.args
        has_else = len(args) % 2 == 1
        pairs = [(args[i], args[i + 1])
                 for i in range(0, len(args) - (1 if has_else else 0), 2)]
        if has_else:
            acc_val, acc_valid = self._branch_val(e, args[-1], cols, memo)
        else:
            acc_val, acc_valid = 0, False
        # fold from the last WHEN to the first
        for c, v in reversed(pairs):
            cv, cm = self._truthy(c, cols, memo)
            cond = cv if cm is True else (cv & cm)
            bv, bm = self._branch_val(e, v, cols, memo)
            acc_val = self._where(cond, bv, acc_val)
            acc_valid = self._where(cond, _mask_arr(bm, bv),
                                    _mask_arr(acc_valid, acc_val))
        return acc_val, acc_valid

    def op_coalesce(self, e, cols, memo):
        val, valid = self._branch_val(e, e.args[-1], cols, memo)
        for a in reversed(e.args[:-1]):
            av, am = self._branch_val(e, a, cols, memo)
            use_a = _lane(_mask_arr(am, av), self.device)
            val = self._where(use_a, av, val)
            valid = use_a | _lane(_mask_arr(valid, val), self.device)
        return val, valid

    def _branch_val(self, parent: Func, a: Expr, cols, memo) -> Pair:
        """Evaluate a CASE/IF branch, coercing to the parent's type."""
        v, m = self._num(a, cols, memo)
        pk = parent.dtype.kind
        if pk in (K.FLOAT64, K.FLOAT32) \
                and a.dtype.kind not in (K.FLOAT64, K.FLOAT32):
            v = self._as_double(v, a.dtype)
        elif pk == K.DECIMAL:
            sa = a.dtype.scale if a.dtype.kind == K.DECIMAL else 0
            if sa < parent.dtype.scale:
                v = self._iwiden("multiply", v,
                                 dec.pow10(parent.dtype.scale - sa))
        if pk in self._INT_FAMILY and self._is_narrow(v):
            # branches of one CASE/IF share a width: a narrow branch
            # beside a wide one would keep the narrow dtype in torch.where
            v = _as_i64(v)
        return v, m

    # -- dictionary lookups ---------------------------------------------- #

    def op_dict_lut(self, e, cols, memo):
        """A dictionary-coded string lane through the lookup table that
        expr/lower_strings.py built on the host over the dictionary (an
        array Const): the codes, clipped to the table, gather it."""
        cv, cm = self.eval(e.args[0], cols, memo)
        key = ("lut", id(e.args[1]))
        if key not in memo:
            memo[key] = torch.as_tensor(e.args[1].value, device=self.device)
        lut = memo[key]
        codes = torch.as_tensor(cv, device=self.device).to(torch.int64)
        return lut[codes.clamp(0, lut.shape[0] - 1)], cm

    # same clip+gather body: code translation reuses the LUT machinery
    op_dict_map = op_dict_lut

    # -- IN -------------------------------------------------------------- #

    def op_in(self, e, cols, memo):
        target, items = e.args[0], e.args[1:]
        tv, tm = self._num(target, cols, memo) if target.dtype.is_numeric \
            else self.eval(target, cols, memo)
        any_match = None
        all_valid = tm
        for it in items:
            iv, im = self._num(it, cols, memo) if it.dtype.is_numeric \
                else self.eval(it, cols, memo)
            a, b = tv, iv
            # unify decimal scales between target and item
            if target.dtype.kind == K.DECIMAL or it.dtype.kind == K.DECIMAL:
                st = target.dtype.scale \
                    if target.dtype.kind == K.DECIMAL else 0
                si = it.dtype.scale if it.dtype.kind == K.DECIMAL else 0
                s = max(st, si)
                if st < s:
                    a = self._iwiden("multiply", tv, dec.pow10(s - st))
                if si < s:
                    b = self._iwiden("multiply", iv, dec.pow10(s - si))
            a, b = self._cmp_fit(a, b)
            match = a == b
            if im is not True:  # a NULL item is never a match
                match = match & im
            any_match = match if any_match is None else (any_match | match)
            all_valid = vand(all_valid, im)
        # true if any valid match; NULL if no match and an operand is NULL
        return any_match, _or3(all_valid, vand(tm, any_match), False)


__all__ = ["Evaluator", "vand"]
