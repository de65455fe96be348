# ported from tidb_tpu/expr/compile.py @ 70ba47f
"""Expression evaluator with MySQL NULL + decimal semantics, on torch.

Every node evaluates to a pair ``(value, valid)``:

- value: a tensor in device representation (scaled ints for DECIMAL,
  dict codes for STRING, days for DATE), or a python scalar for a
  constant; comparisons and logic yield bool tensors;
- valid: a bool tensor, or the literal ``True`` meaning "all valid", or
  ``False`` for a NULL constant.

It has a lane for every op the planner pushes down
(``executor/physical.py::DEVICE_OPS``): arithmetic with MySQL decimal
scales (``/`` rounds half away from zero, ``DIV`` and ``%`` truncate
toward zero), the comparisons, three-valued logic, IN, IF / CASE /
COALESCE, the dictionary lookups, CAST between the numeric and temporal
kinds, the math functions and the temporal functions.  String casts are
lowered onto dictionary codes before they get here, as in the JAX
package, which raises for an unlowered one; so does the port.

BIGINT UNSIGNED values ride as the int64 tensor of the same bits:
torch has no uint64 ``<``, ``//``, ``%`` or ``+`` (ROADMAP.md, "Pinned
hazards").  ``_num`` hands every op the bits; add, subtract and multiply
wrap as uint64 does; a comparison flips the sign bit of both sides; a
division takes ``_udiv``'s exact unsigned quotient; and a result typed
BIGINT UNSIGNED goes back out as a uint64 view, the dtype of an
unsigned column (``_eval``).  A float converts to an integer saturating,
NaN to 0, as XLA's convert does (``_f2i64``, ``_f2u64``).

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
from ..types.temporal import MICROS_PER_DAY, MICROS_PER_SEC
from .ir import ColumnRef, Const, Expr, Func

K = dt.TypeKind

Pair = tuple[Any, Any]  # (value, valid)

_NARROW_INTS = (torch.int8, torch.int16, torch.int32, torch.uint8)
_I64_MIN, _I64_MAX = -2 ** 63, 2 ** 63 - 1


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
    """A value at int64, as ``astype(int64)`` gives it: an integer tensor
    widened (a uint64 one as its bits), a float one truncated and
    saturated (``_f2i64``), a python scalar as a python int."""
    if _is_tensor(v):
        if v.is_floating_point():
            return _f2i64(v.to(torch.float64))
        return _bits(v)
    return int(v)


def _bits(v):
    """A BIGINT UNSIGNED value as int64 bits: a uint64 tensor viewed, a
    python int past 2^63 - 1 taken modulo 2^64 into the signed range;
    other integer tensors widen to int64."""
    if _is_tensor(v):
        if v.dtype == torch.uint64:
            return v.view(torch.int64)
        if v.dtype in _NARROW_INTS or v.dtype == torch.bool:
            return v.to(torch.int64)
        return v
    if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        v = int(v)
        return v - 2 ** 64 if v > _I64_MAX else v
    return v


def _ukey(v):
    """The int64 whose signed order is the unsigned order of bits ``v``."""
    return v ^ _I64_MIN


def _udiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact uint64 ``a // b`` on int64 bits, ``b`` nonzero, without
    floats: a divisor with its top bit set goes at most once; else the
    dividend is halved (a logical shift), divided, doubled, and the
    quotient corrected by one where the remainder still holds ``b``."""
    big = b < 0
    bs = torch.where(big, torch.ones_like(b), b)
    h = (a >> 1) & _I64_MAX
    q = (h // bs) * 2
    r = a - q * bs
    q = q + (_ukey(r) >= _ukey(bs)).to(torch.int64)
    q_big = (_ukey(a) >= _ukey(b)).to(torch.int64)
    return torch.where(big, q_big, q)


def _f2i64(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 truncating and saturating, NaN -> 0: what XLA's
    convert gives (a plain torch cast of an out-of-range value is
    undefined)."""
    ok = (x >= -2.0 ** 63) & (x < 2.0 ** 63)
    out = torch.where(ok, x, torch.zeros((), dtype=x.dtype,
                                         device=x.device)).to(torch.int64)
    out = torch.where(x >= 2.0 ** 63, _I64_MAX, out)
    return torch.where(x < -2.0 ** 63, _I64_MIN, out)


def _f2u64(x: torch.Tensor) -> torch.Tensor:
    """float64 -> uint64 (as int64 bits) truncating and saturating at 0
    and 2^64 - 1, NaN -> 0, as XLA's convert does."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    low = torch.where((x > 0) & (x < 2.0 ** 63), x, zero).to(torch.int64)
    high = torch.where((x >= 2.0 ** 63) & (x < 2.0 ** 64), x - 2.0 ** 63,
                       zero).to(torch.int64) ^ _I64_MIN
    out = torch.where(x >= 2.0 ** 63, high, low)
    return torch.where(x >= 2.0 ** 64, -1, out)


def _u2f(v: torch.Tensor) -> torch.Tensor:
    """uint64 bits -> float64, rounded once: the high and low 32-bit
    halves are exact in float64 and their sum rounds to nearest."""
    hi = ((v >> 32) & 0xFFFFFFFF).to(torch.float64)
    lo = (v & 0xFFFFFFFF).to(torch.float64)
    return hi * 4294967296.0 + lo


def _trunc_div(a, b):
    """Integer division truncating toward zero (MySQL DIV), div-by-0-safe."""
    safe = torch.where(b == 0, 1, b)
    q = torch.floor_divide(torch.abs(a), torch.abs(safe))
    sign = torch.where((a < 0) != (safe < 0), -1, 1)
    return sign * q


def _round_div(a, b):
    """Integer division rounding half away from zero (MySQL decimal div)."""
    safe = torch.where(b == 0, 1, b)
    absb = torch.abs(safe)
    q = torch.floor_divide(torch.abs(a) + absb // 2, absb)
    sign = torch.where((a < 0) != (safe < 0), -1, 1)
    return sign * q


def _round_div_u(a, b):
    """``_round_div`` of int64 ``a`` by a uint64 divisor ``b`` (its int64
    bits): |a| + b // 2 stays under 2^64, so the unsigned quotient is
    exact (``_udiv``) and takes ``a``'s sign."""
    safe = torch.where(b == 0, 1, b)
    q = _udiv(torch.abs(a) + ((safe >> 1) & _I64_MAX), safe)
    return torch.where(a < 0, -q, q)


def _div_valid(ma, mb, vb):
    return vand(vand(ma, mb), vb != 0)


def _pymod(a, b):
    """Floor (python-style, non-negative for a positive divisor) modulo:
    calendar arithmetic stays right for pre-epoch dates.
    ``torch.remainder`` is floor-mod (``torch.fmod`` truncates)."""
    return torch.remainder(a, b)


# -- the calendar (types/temporal.py's, on int64 tensors) ---------------- #

def _civil_from_days(days):
    """(year, month, day) of days since 1970-01-01 (Howard Hinnant's
    algorithm, floor divisions: right before the epoch too)."""
    z = days + 719468
    era = torch.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y, m, d):
    """Days since 1970-01-01 of (y, m, d), the inverse of
    ``_civil_from_days`` as the JAX package's ``types/temporal.py``
    computes it (its era is a floor division of ``y - 399`` below year
    0); ``m`` and ``d`` may be python ints."""
    if _is_tensor(m):
        y = y - (m <= 2).to(torch.int64)
        mo = m + torch.where(m > 2, -3, 9)
    else:
        y = y - int(m <= 2)
        mo = m + (-3 if m > 2 else 9)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    doy = (153 * mo + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _days_in_month(y, m):
    table = torch.tensor(_MONTH_DAYS, dtype=torch.int64, device=m.device)
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    return table[torch.clamp(m - 1, 0, 11)] + (leap & (m == 2)).to(
        torch.int64)


def _jan1(y):
    """Days since the epoch of January 1st of year(s) ``y``."""
    return _days_from_civil(y, 1, 1)


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
            if isinstance(e.value, np.ndarray):
                return torch.as_tensor(e.value, device=self.device), True
            if isinstance(e.value, str):
                # dictionary lowering (expr/lower_strings.py) turns every
                # string constant of a pushed-down expression into codes
                raise TypeError(f"unlowered string constant {e.value!r} "
                                "in a device expression")
            return e.value, True
        if not isinstance(e, Func):
            raise TypeError(f"not an expression: {e!r}")
        fn = getattr(self, f"op_{e.op}", None)
        if fn is None:
            # DEVICE_OPS holds no op without a lane here (pinned by the
            # parity tests), so the planner never pushes this one down
            raise NotImplementedError(f"op {e.op}")
        v, m = fn(e, cols, memo)
        if e.dtype is not None and e.dtype.kind == K.UINT64 \
                and _is_tensor(v) and v.dtype == torch.int64:
            v = v.view(torch.uint64)      # unsigned bits out as uint64
        return v, m

    # -- helpers --------------------------------------------------------- #

    def _t(self, v):
        return _lane(v, self.device)

    def _num(self, a: Expr, cols, memo):
        """Evaluate a numeric operand: a bool compare-result as int, a
        BIGINT UNSIGNED value as its int64 bits."""
        v, m = self.eval(a, cols, memo)
        if _is_tensor(v):
            if v.dtype == torch.bool:
                v = v.to(torch.int64)
            elif v.dtype == torch.uint64:
                v = v.view(torch.int64)
        elif isinstance(v, bool):
            v = int(v)
        elif a.dtype is not None and a.dtype.kind == K.UINT64:
            v = _bits(v)
        return v, m

    @staticmethod
    def _iwiden(op: str, va, vb):
        """Integer add/sub/mul at the full int64 width whatever the
        physical width of a tensor operand (uint64 wraps the same on its
        bits); python scalars keep exact python arithmetic."""
        if not _is_tensor(va) and not _is_tensor(vb):
            return {"add": lambda: va + vb, "subtract": lambda: va - vb,
                    "multiply": lambda: va * vb}[op]()
        if _is_tensor(va) and va.dtype != torch.int64:
            va = _bits(va)
        if _is_tensor(vb) and vb.dtype != torch.int64:
            vb = _bits(vb)
        return {"add": torch.add, "subtract": torch.sub,
                "multiply": torch.mul}[op](va, vb)

    @staticmethod
    def _is_narrow(v) -> bool:
        return _is_tensor(v) and v.dtype in _NARROW_INTS

    @staticmethod
    def _cmp_fit(va, vb):
        """Make a comparison width-safe: a python int that fits a narrow
        tensor's dtype is compared at that width; otherwise every integer
        tensor side widens to int64 (torch would wrap the scalar).  A
        python int past int64 (a wide decimal's rescale) orders above or
        below every int64 value, as the JAX package's exact object-int
        compare finds: the pair becomes (0, 1) or (1, 0) over the
        tensor's shape."""
        for x, y, flip in ((va, vb, False), (vb, va, True)):
            if isinstance(y, (int, np.integer)) and not isinstance(y, bool):
                y = int(y)
                if not _I64_MIN <= y <= _I64_MAX and _is_tensor(x):
                    z = torch.zeros(x.shape, dtype=torch.int64,
                                    device=x.device)
                    big = 1 if y > 0 else -1
                    return (big, z) if flip else (z, big)
                if _is_tensor(x) and x.dtype in _NARROW_INTS:
                    info = torch.iinfo(x.dtype)
                    if info.min <= y <= info.max:
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
        # DATE (days) vs DATETIME (micros): DATE goes up, MySQL-style
        if {ka, kb} == {K.DATE, K.DATETIME}:
            if ka == K.DATE:
                va = _as_i64(va) * MICROS_PER_DAY
            else:
                vb = _as_i64(vb) * MICROS_PER_DAY
            return va, ma, vb, mb, dt.datetime()
        # signed against unsigned BIGINT: both as uint64 two's complement
        # (``_num`` gave the bits); ``_cmp`` orders a negative signed
        # value below every unsigned one
        if {ka, kb} == {K.INT64, K.UINT64}:
            return _as_i64(va), ma, _as_i64(vb), mb, dt.ubigint()
        return va, ma, vb, mb, (a.dtype if ka != K.NULL else b.dtype)

    @staticmethod
    def _as_double(v, t: dt.DataType):
        if t.kind == K.DECIMAL:
            return v.to(torch.float64) / float(dec.pow10(t.scale)) \
                if _is_tensor(v) else float(v) / dec.pow10(t.scale)
        if t.kind == K.UINT64:
            return _u2f(_bits(v)) if _is_tensor(v) \
                else float(int(v) % 2 ** 64)
        if _is_tensor(v):
            return v.to(torch.float64)
        return float(v)

    def _truthy(self, e: Expr, cols, memo) -> Pair:
        """MySQL truthiness: nonzero numeric = true.  A scalar becomes a
        0-d bool tensor so ``~`` and ``&`` keep boolean semantics."""
        v, m = self.eval(e, cols, memo)
        if _is_tensor(v):
            return (v if v.dtype == torch.bool else _bits(v) != 0), m
        return torch.tensor(v != 0, device=self.device), m

    # -- arithmetic ------------------------------------------------------ #

    _INT_FAMILY = (K.INT64, K.UINT64, K.DECIMAL, K.DATE, K.DATETIME,
                   K.TIME)

    def _arith(self, op: str, va, vb, t):
        """Add/sub/mul honoring the logical (int64) width when a physical
        operand is narrow."""
        if t.kind in self._INT_FAMILY and (self._is_narrow(va)
                                           or self._is_narrow(vb)):
            return self._iwiden(op, va, vb)
        return {"add": lambda: va + vb, "subtract": lambda: va - vb,
                "multiply": lambda: va * vb}[op]()

    # The JAX package's host (numpy) lanes raise on a scaled-int64
    # DECIMAL overflow (its ``_guard_dec_overflow``, in the port's
    # expr/host_eval.py); its device lanes cannot raise data-dependently
    # and wrap, and so do these.

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

    def op_div(self, e, cols, memo):
        a, b = e.args
        if e.dtype.kind == K.DECIMAL:
            sa = a.dtype.scale if a.dtype.kind == K.DECIMAL else 0
            sb = b.dtype.scale if b.dtype.kind == K.DECIMAL else 0
            k = e.dtype.scale - sa + sb
            va, ma = self._num(a, cols, memo)
            vb, mb = self._num(b, cols, memo)
            # k < 0 (result scale capped below the dividend's): scale the
            # divisor instead, so pow10 stays integral and exact
            div = _round_div
            if k >= 0:
                num = self._iwiden("multiply", va, dec.pow10(k))
                den = _as_i64(vb) if self._is_narrow(vb) else vb
                if b.dtype.kind == K.UINT64:
                    # the JAX package's int64-by-uint64 division promotes
                    # to float64; the port divides the bits exactly
                    div = _round_div_u
            else:
                num = _as_i64(va) if self._is_narrow(va) else va
                den = self._iwiden("multiply", vb, dec.pow10(-k))
            return (div(self._t(num), self._t(den)),
                    _div_valid(ma, mb, self._t(vb)))
        va, ma = self._num(a, cols, memo)
        vb, mb = self._num(b, cols, memo)
        va = self._t(self._as_double(va, a.dtype))
        vb = self._t(self._as_double(vb, b.dtype))
        safe = torch.where(vb == 0, 1.0, vb)
        return va / safe, _div_valid(ma, mb, vb)

    def _int_operands(self, e, cols, memo):
        va, ma, vb, mb, t = self._to_common(e, cols, memo)
        if t.kind in (K.FLOAT64, K.FLOAT32):
            return self._t(va), ma, self._t(vb), mb, t
        return self._t(_as_i64(va)), ma, self._t(_as_i64(vb)), mb, t

    def _int_quot(self, va, vb, t):
        """MySQL DIV's quotient of two integer-family tensors: uint64
        bits divide unsigned, the rest truncate toward zero."""
        if t.kind == K.UINT64:
            return _udiv(va, torch.where(vb == 0, 1, vb))
        return _trunc_div(va, vb)

    def op_intdiv(self, e, cols, memo):
        va, ma, vb, mb, t = self._int_operands(e, cols, memo)
        if t.kind == K.FLOAT64:
            safe = torch.where(vb == 0, 1.0, vb)
            q = _f2i64(torch.trunc(va / safe))
        else:
            q = self._int_quot(va, vb, t)
        return q, _div_valid(ma, mb, vb)

    def op_mod(self, e, cols, memo):
        va, ma, vb, mb, t = self._int_operands(e, cols, memo)
        if t.kind == K.FLOAT64:
            safe = torch.where(vb == 0, 1.0, vb)
            r = va - torch.trunc(va / safe) * vb
        else:
            r = va - self._int_quot(va, vb, t) * vb
        return r, _div_valid(ma, mb, vb)

    def op_neg(self, e, cols, memo):
        v, m = self._num(e.args[0], cols, memo)
        if self._is_narrow(v):
            v = _as_i64(v)             # -(INT_MIN of the narrow width)
        return -v, m

    def op_abs(self, e, cols, memo):
        v, m = self._num(e.args[0], cols, memo)
        if e.args[0].dtype.kind == K.UINT64:
            return v, m                # |uint64| is itself
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
        ka, kb = a.dtype.kind, b.dtype.kind
        if {ka, kb} == {K.INT64, K.UINT64}:
            # sign-aware: a negative signed value orders below every
            # unsigned value; otherwise compare as uint64
            va, ma = self._num(a, cols, memo)
            vb, mb = self._num(b, cols, memo)
            va, vb = self._t(_as_i64(va)), self._t(_as_i64(vb))
            res = fn(_ukey(va), _ukey(vb))
            if ka == K.INT64:
                res = torch.where(va < 0, fn(-1, 0), res)
            else:
                res = torch.where(vb < 0, fn(0, -1), res)
            return res, vand(ma, mb)
        va, ma, vb, mb, t = self._to_common(e, cols, memo)
        if t.kind == K.UINT64:
            return fn(_ukey(self._t(_as_i64(va))),
                      _ukey(self._t(_as_i64(vb)))), vand(ma, mb)
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
            if _is_tensor(v) and v.dim():
                return torch.zeros(v.shape, dtype=torch.bool,
                                   device=v.device), True
            return False, True
        if m is False:
            return True, True
        return ~m, True

    # -- IF / CASE / COALESCE -------------------------------------------- #

    def _where(self, cond, a, b):
        return torch.where(self._t(cond), self._t(a), self._t(b))

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
            use_a = self._t(_mask_arr(am, av))
            val = self._where(use_a, av, val)
            valid = use_a | self._t(_mask_arr(valid, val))
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
            elif K.UINT64 in (target.dtype.kind, it.dtype.kind):
                a, b = _bits(a), _bits(b)
            a, b = self._cmp_fit(a, b)
            match = a == b
            if im is not True:  # a NULL item is never a match
                match = match & im
            any_match = match if any_match is None else (any_match | match)
            all_valid = vand(all_valid, im)
        # true if any valid match; NULL if no match and an operand is NULL
        return any_match, _or3(all_valid, vand(tm, any_match), False)

    # -- math builtins ---------------------------------------------------- #

    def op_ceil(self, e, cols, memo):
        return self._ceil_floor(e, cols, memo, torch.ceil)

    def op_floor(self, e, cols, memo):
        return self._ceil_floor(e, cols, memo, torch.floor)

    def _ceil_floor(self, e, cols, memo, fn):
        a = e.args[0]
        v, m = self._num(a, cols, memo)
        if a.dtype.is_float:
            return fn(self._t(self._as_double(v, a.dtype))), m
        v = self._t(_as_i64(v))
        if a.dtype.kind == K.DECIMAL:
            p = dec.pow10(a.dtype.scale)
            q = torch.floor_divide(v, p)
            if fn is torch.ceil:
                q = q + ((v - q * p) != 0).to(torch.int64)
            return q, m
        return v, m

    def op_round(self, e, cols, memo):
        return self._round_trunc(e, cols, memo, False)

    def op_truncate(self, e, cols, memo):
        return self._round_trunc(e, cols, memo, True)

    def _round_trunc(self, e, cols, memo, trunc: bool):
        """ROUND / TRUNCATE: a double rounds half away from zero (not
        ``torch.round``'s half to even); a decimal or an integer divides
        by a power of ten, rounding half away or truncating."""
        a, d = e.args
        nd = int(d.value)
        v, m = self._num(a, cols, memo)
        if a.dtype.is_float:
            f = self._t(self._as_double(v, a.dtype))
            p = 10.0 ** nd
            scaled = f * p
            if trunc:
                out = torch.trunc(scaled) / p
            else:
                out = torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                                  torch.ceil(scaled - 0.5)) / p
            return out, m
        div = _trunc_div if trunc else _round_div
        if a.dtype.kind == K.DECIMAL:
            v = self._t(_as_i64(v))
            drop = a.dtype.scale - e.dtype.scale
            if drop > 0:
                v = div(v, self._t(dec.pow10(drop)))
            if nd < 0:   # ROUND(dec, -k): also round off integer digits
                p2 = dec.pow10(-nd)
                v = div(v, self._t(p2)) * p2
            return v, m
        if nd < 0:       # integer rounding to powers of ten
            p = dec.pow10(-nd)
            return div(self._t(_as_i64(v)), self._t(p)) * p, m
        return v, m

    def op_sign(self, e, cols, memo):
        a = e.args[0]
        v, m = self._num(a, cols, memo)
        v = self._t(v)
        if a.dtype.kind == K.UINT64:
            return (v != 0).to(torch.int64), m
        s = torch.sign(v)
        return (_f2i64(s) if s.is_floating_point()
                else s.to(torch.int64)), m

    def _double1(self, e, cols, memo):
        a = e.args[0]
        v, m = self._num(a, cols, memo)
        return self._t(self._as_double(v, a.dtype)), m

    def op_sqrt(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return torch.sqrt(torch.where(v < 0, 0.0, v)), vand(m, v >= 0)

    def op_exp(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return torch.exp(v), m

    def op_ln(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return torch.log(torch.where(v <= 0, 1.0, v)), vand(m, v > 0)

    def op_log(self, e, cols, memo):
        if len(e.args) == 1:
            return self.op_ln(e, cols, memo)
        # LOG(base, x)
        bv, bm = self._num(e.args[0], cols, memo)
        b = self._t(self._as_double(bv, e.args[0].dtype))
        xv, xm = self._num(e.args[1], cols, memo)
        x = self._t(self._as_double(xv, e.args[1].dtype))
        ok = (x > 0) & (b > 0) & (b != 1.0)
        num = torch.log(torch.where(x <= 0, 1.0, x))
        den = torch.log(torch.where((b <= 0) | (b == 1.0), 2.0, b))
        return num / den, vand(vand(bm, xm), ok)

    def op_log2(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return torch.log2(torch.where(v <= 0, 1.0, v)), vand(m, v > 0)

    def op_log10(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return torch.log10(torch.where(v <= 0, 1.0, v)), vand(m, v > 0)

    def op_pow(self, e, cols, memo):
        bv, bm = self._num(e.args[0], cols, memo)
        ev_, em = self._num(e.args[1], cols, memo)
        b = self._t(self._as_double(bv, e.args[0].dtype))
        x = self._t(self._as_double(ev_, e.args[1].dtype))
        # a negative base with a fractional exponent -> NULL
        ok = (b >= 0) | (x == torch.floor(x))
        out = torch.pow(torch.where(ok, b, 1.0), x)
        return out, vand(vand(bm, em), ok)

    def op_sin(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return torch.sin(v), m

    def op_cos(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return torch.cos(v), m

    def op_tan(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return torch.tan(v), m

    def op_cot(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        t = torch.tan(v)
        return 1.0 / torch.where(t == 0, 1.0, t), vand(m, t != 0)

    def op_asin(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        ok = (v >= -1) & (v <= 1)
        return torch.asin(torch.clamp(v, -1, 1)), vand(m, ok)

    def op_acos(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        ok = (v >= -1) & (v <= 1)
        return torch.acos(torch.clamp(v, -1, 1)), vand(m, ok)

    def op_atan(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return torch.atan(v), m

    def op_atan2(self, e, cols, memo):
        av, am = self._num(e.args[0], cols, memo)
        bv, bm = self._num(e.args[1], cols, memo)
        return torch.atan2(
            self._t(self._as_double(av, e.args[0].dtype)),
            self._t(self._as_double(bv, e.args[1].dtype))), vand(am, bm)

    def op_radians(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return v * (np.pi / 180.0), m

    def op_degrees(self, e, cols, memo):
        v, m = self._double1(e, cols, memo)
        return v * (180.0 / np.pi), m

    def _minmax_chain(self, e, cols, memo, pick_first):
        if e.dtype.is_string and getattr(e, "_derived_dict", None) is None:
            raise NotImplementedError(
                f"{e.op.upper()} over strings requires dictionary-encoded "
                "columns (merged-code lowering did not apply)")
        unsigned = e.dtype.kind == K.UINT64
        val = valid = None
        for a in e.args:
            v, m = self._branch_val(e, a, cols, memo)
            v = self._t(v)
            if val is None:
                val, valid = v, m
                continue
            if unsigned:
                val = torch.where(pick_first(_ukey(val), _ukey(v)), val, v)
            elif val.is_floating_point() or v.is_floating_point():
                # NaN wins, as jnp.maximum / jnp.minimum give it
                val = (torch.maximum if pick_first is torch.ge
                       else torch.minimum)(val, v)
            else:
                val = torch.where(pick_first(val, v), val, v)
            valid = vand(valid, m)   # MySQL: NULL if any argument is NULL
        return val, valid

    def op_greatest(self, e, cols, memo):
        return self._minmax_chain(e, cols, memo, torch.ge)

    def op_least(self, e, cols, memo):
        return self._minmax_chain(e, cols, memo, torch.le)

    # -- temporal --------------------------------------------------------- #

    def _days_of(self, a: Expr, cols, memo):
        v, m = self.eval(a, cols, memo)
        v = self._t(_as_i64(v))
        if a.dtype.kind == K.DATETIME:
            v = torch.floor_divide(v, MICROS_PER_DAY)
        return v, m

    def _ymd(self, a: Expr, cols, memo):
        days, m = self._days_of(a, cols, memo)
        y, mo, d = _civil_from_days(days)
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

    def op_dayofweek(self, e, cols, memo):
        # 1 = Sunday (ODBC); epoch day 0 = Thursday
        days, m = self._days_of(e.args[0], cols, memo)
        return _pymod(days + 4, 7) + 1, m

    def op_weekday(self, e, cols, memo):
        # 0 = Monday
        days, m = self._days_of(e.args[0], cols, memo)
        return _pymod(days + 3, 7), m

    def op_dayofyear(self, e, cols, memo):
        days, m = self._days_of(e.args[0], cols, memo)
        y, _, _ = _civil_from_days(days)
        return days - _jan1(y) + 1, m

    def op_quarter(self, e, cols, memo):
        _, mo, _, m = self._ymd(e.args[0], cols, memo)
        return (mo + 2) // 3, m

    def _time_part(self, e, cols, memo, div, mod):
        a = e.args[0]
        v, m = self.eval(a, cols, memo)
        v = self._t(_as_i64(v))
        if a.dtype.kind == K.DATE:
            return torch.zeros_like(v), m
        tod = _pymod(v, MICROS_PER_DAY)
        return _pymod(tod // div, mod), m

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
        return da - db, vand(ma, mb)

    def op_dateadd_days(self, e, cols, memo):
        a, n = e.args
        v, m = self.eval(a, cols, memo)
        nv, nm = self._num(n, cols, memo)
        step = MICROS_PER_DAY if a.dtype.kind == K.DATETIME else 1
        return (self._t(_as_i64(v)) + self._t(_as_i64(nv)) * step,
                vand(m, nm))

    def op_dateadd_months(self, e, cols, memo):
        """DATE_ADD(d, INTERVAL n MONTH): the day clamps to the target
        month's last day."""
        a, n = e.args
        v, m = self.eval(a, cols, memo)
        nv, nm = self._num(n, cols, memo)
        v = self._t(_as_i64(v))
        is_dt = a.dtype.kind == K.DATETIME
        days = torch.floor_divide(v, MICROS_PER_DAY) if is_dt else v
        tod = v - days * MICROS_PER_DAY if is_dt else 0
        y, mo, d = _civil_from_days(days)
        mi = y * 12 + (mo - 1) + self._t(_as_i64(nv))
        y2 = torch.floor_divide(mi, 12)
        mo2 = mi - y2 * 12 + 1
        d2 = torch.minimum(d, _days_in_month(y2, mo2))
        out_days = _days_from_civil(y2, mo2, d2)
        out = out_days * MICROS_PER_DAY + tod if is_dt else out_days
        return out, vand(m, nm)

    def op_dateadd_micros(self, e, cols, memo):
        a, n = e.args
        v, m = self.eval(a, cols, memo)
        nv, nm = self._num(n, cols, memo)
        return self._t(_as_i64(v)) + self._t(_as_i64(nv)), vand(m, nm)

    def op_last_day(self, e, cols, memo):
        y, mo, _d, m = self._ymd(e.args[0], cols, memo)
        return _days_from_civil(y, mo, _days_in_month(y, mo)), m

    def op_to_days(self, e, cols, memo):
        # MySQL TO_DAYS: days since year 0 (epoch 1970-01-01 = 719528)
        days, m = self._days_of(e.args[0], cols, memo)
        return days + 719528, m

    def op_from_days(self, e, cols, memo):
        v, m = self._num(e.args[0], cols, memo)
        return self._t(_as_i64(v)) - 719528, m

    def op_week(self, e, cols, memo):
        """WEEK(d[, mode]): mode 0 (MySQL's default, Sunday-start, week
        1 = the first week with a Sunday) and mode 3 (ISO 8601,
        Monday-start), as the JAX package computes them."""
        days, m = self._days_of(e.args[0], cols, memo)
        mode = int(e.args[1].value) if len(e.args) > 1 else 0
        if mode == 3:
            # the ISO week of d is the week of d's Thursday
            thursday = days - (days + 3) % 7 + 3
            y, _, _ = _civil_from_days(thursday)
            return (thursday - _jan1(y)) // 7 + 1, m
        y, _, _ = _civil_from_days(days)
        j = _jan1(y)
        fs = j + (7 - (j + 4) % 7) % 7       # the year's first Sunday
        return torch.clamp(torch.floor_divide(days - fs, 7) + 1,
                           min=0), m

    def op_from_unixtime(self, e, cols, memo):
        """FROM_UNIXTIME(n): seconds since the epoch as DATETIME micros,
        in UTC as in the JAX package (a DECIMAL's fraction kept to the
        microsecond)."""
        v, m = self._num(e.args[0], cols, memo)
        a = e.args[0]
        v = self._t(_as_i64(v))
        if a.dtype.kind == K.DECIMAL:
            return v * (MICROS_PER_SEC
                        // dec.pow10(min(a.dtype.scale, 6))), m
        return v * MICROS_PER_SEC, m

    def op_makedate(self, e, cols, memo):
        """MAKEDATE(year, dayofyear) -> DATE; NULL when dayofyear < 1."""
        y, my = self._num(e.args[0], cols, memo)
        doy, md = self._num(e.args[1], cols, memo)
        y = self._t(_as_i64(y))
        doy = self._t(_as_i64(doy))
        return _jan1(y) + doy - 1, vand(vand(my, md), doy >= 1)

    def op_unix_timestamp(self, e, cols, memo):
        """UNIX_TIMESTAMP(d): whole seconds since the epoch, UTC."""
        a = e.args[0]
        v, m = self.eval(a, cols, memo)
        v = self._t(_as_i64(v))
        if a.dtype.kind == K.DATE:
            v = v * MICROS_PER_DAY
        return torch.floor_divide(v, MICROS_PER_SEC), m

    # -- casts ------------------------------------------------------------ #

    def op_cast(self, e, cols, memo):
        a = e.args[0]
        src, dst = a.dtype, e.dtype
        if src.is_string or dst.is_string:
            # string casts are lowered onto dictionary codes
            # (lower_strings._lower_cast_strings) or routed to the host's
            # cast_char; evaluating one here would cast raw dict CODES
            raise NotImplementedError(f"unlowered string cast {src} -> {dst}")
        if src.is_wide_decimal or dst.is_wide_decimal:
            # a 19-65 digit decimal is a host object lane, never pushed
            # down (physical._device_supported)
            raise TypeError(f"wide DECIMAL cast {src} -> {dst} in a device "
                            "expression")
        v, m = self._num(a, cols, memo)
        if dst.kind in (K.FLOAT64, K.FLOAT32):
            out = self._as_double(v, src)
            if dst.kind == K.FLOAT32 and _is_tensor(out):
                out = out.to(torch.float32)
            return out, m
        v = self._t(v)
        if dst.kind == K.DECIMAL:
            if src.kind == K.DECIMAL:
                ds = dst.scale - src.scale
                if ds >= 0:
                    return self._iwiden("multiply", v, dec.pow10(ds)), m
                return _round_div(_as_i64(v), self._t(dec.pow10(-ds))), m
            if src.is_float:
                scaled = v.to(torch.float64) * float(dec.pow10(dst.scale))
                out = torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                                  torch.ceil(scaled - 0.5))
                return _f2i64(out), m
            return self._iwiden("multiply", v, dec.pow10(dst.scale)), m
        if dst.kind in (K.INT64, K.UINT64):
            if src.kind == K.DECIMAL:
                return _round_div(_as_i64(v),
                                  self._t(dec.pow10(src.scale))), m
            if src.is_float:
                out = torch.where(v >= 0, torch.floor(v + 0.5),
                                  torch.ceil(v - 0.5)).to(torch.float64)
                return (_f2i64(out) if dst.kind == K.INT64
                        else _f2u64(out)), m
            return _as_i64(v), m
        if dst.kind == K.DATETIME and src.kind == K.DATE:
            return _as_i64(v) * MICROS_PER_DAY, m
        if dst.kind == K.DATE and src.kind == K.DATETIME:
            return torch.floor_divide(_as_i64(v), MICROS_PER_DAY), m
        if dst.kind == K.DATETIME and src.kind in (K.INT64, K.UINT64):
            # MySQL numeric->DATETIME: digits read as [YYYYMMDD]HHMMSS
            iv = _as_i64(v)
            # date-only digits scale to [YYYYMMDD]000000; the other lane
            # is zeroed before the multiply (14 digits times 10^6 would
            # wrap int64 in the discarded lane)
            date_only = iv < 10 ** 8
            iv = torch.where(date_only, iv, 0) * 10 ** 6 \
                + torch.where(date_only, 0, iv)
            y = iv // 10 ** 10
            mo = iv // 10 ** 8 % 100
            d = iv // 10 ** 6 % 100
            h = iv // 10 ** 4 % 100
            mi = iv // 100 % 100
            sec = iv % 100
            ok = ((mo >= 1) & (mo <= 12) & (d >= 1) & (d <= 31)
                  & (h < 24) & (mi < 60) & (sec < 60))
            days = _days_from_civil(y, mo, d)
            # calendar validation: Feb 31 etc. is NULL, not rolled over
            y2, m2, d2 = _civil_from_days(days)
            ok = ok & (y2 == y) & (m2 == mo) & (d2 == d)
            micros = (days * 86_400 + h * 3600 + mi * 60 + sec) * 1_000_000
            mm = ok if m is True else _mask_arr(m, micros) & ok
            return torch.where(ok, micros, 0), mm
        if dst.kind == K.TIME and src.kind in (K.INT64, K.UINT64):
            # MySQL numeric->TIME: digits read as [H]HMMSS
            iv = _as_i64(v)
            neg = iv < 0
            av2 = torch.abs(iv)
            h = av2 // 10 ** 4
            mi = av2 // 100 % 100
            sec = av2 % 100
            ok = (mi < 60) & (sec < 60)
            us = (h * 3600 + mi * 60 + sec) * 1_000_000
            us = torch.where(neg, -us, us)
            mm = ok if m is True else _mask_arr(m, us) & ok
            return torch.where(ok, us, 0), mm
        if dst.kind == K.TIME and src.kind == K.DATETIME:
            # the time of day (MySQL CAST(datetime AS TIME))
            return _as_i64(v) % MICROS_PER_DAY, m
        if dst.kind == src.kind:
            return _as_i64(v), m
        raise NotImplementedError(f"cast {src} -> {dst}")


__all__ = ["Evaluator", "vand"]
