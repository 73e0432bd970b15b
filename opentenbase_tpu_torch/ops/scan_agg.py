"""Fused scan -> WHERE -> SUM/COUNT per shard: the Hopper kernel that
replaces the reference's Pallas kernel (opentenbase_tpu/ops/pallas_scan.py,
``build_partials`` + ``combine_partials``).

Three parts:

- the certifier, copied from the reference (``bound``,
  ``certify_predicate``, ``decompose_value``, ``plan_group_keys``,
  ``inline_projects``): it decides which queries take the kernel, so the
  port admits exactly the queries the reference admits;
- an expression-program compiler: certified TExprs become a flat int64
  bytecode (column load, constant, ``+ - *``, unary ``-``, the six
  comparisons, ``and or not``; IN-lists lower to ORs of ``=``). One
  program for the predicate, one for the dense group key, one per SUM
  argument;
- ``scan_agg``, the wrapper of the CUDA kernel in ``csrc/scan_agg.cu``,
  with its plain PyTorch version ``scan_agg_plain`` beside it. The
  wrapper runs the plain version for tensors on the CPU only; for CUDA
  tensors it launches the kernel or raises.

Numerics. The reference computes in f32 limbs because Mosaic is 32-bit;
the certifier bounds every operand below 2^24 and every product below
2^36 (a limb-split product), so the int64 evaluation here is exact and
its int64 sums equal ``combine_partials``' wherever those are exact
(totals to about 2^47).
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.ops import cuda_build
from opentenbase_tpu_torch.plan import texpr as E

LIMB = 4096.0  # the reference's limb radix: v = hi*LIMB + lo
EXACT = float(1 << 24)  # f32-exact integer bound of the reference kernel


class PallasUnsupported(Exception):
    """Outside the certified subset (the reference's name, kept so the
    copied certifier reads as the reference)."""


# ---------------------------------------------------------------------------
# Certification (copied from opentenbase_tpu/ops/pallas_scan.py)
# ---------------------------------------------------------------------------

_CMP = {"=", "<>", "!=", "<", "<=", ">", ">="}
_BOOL = {"and", "or"}


def _is_int_type(ty: t.SqlType) -> bool:
    # decimal/date/timestamp are scaled/epoch integers in physical form
    return ty.id in (
        t.TypeId.INT4, t.TypeId.INT8, t.TypeId.BOOL,
        t.TypeId.DECIMAL, t.TypeId.DATE,
    )


def bound(e: E.TExpr, col_bounds: list) -> Optional[float]:
    """Max |value| of an integer-valued numeric expression, or None when
    the expression leaves the certifiable subset (floats, division,
    strings, NULL-able columns are handled by the caller's column gate).
    """
    if isinstance(e, E.Col):
        if not _is_int_type(e.type):
            return None
        return col_bounds[e.index]
    if isinstance(e, E.Const):
        if e.value is None or not _is_int_type(e.type):
            return None
        return abs(float(e.value))
    if isinstance(e, E.CastE):
        if not _is_int_type(e.type):
            return None
        return bound(e.operand, col_bounds)
    if isinstance(e, E.UnaryE) and e.op == "-":
        return bound(e.operand, col_bounds)
    if isinstance(e, E.BinE) and e.op in ("+", "-", "*"):
        lb = bound(e.left, col_bounds)
        rb = bound(e.right, col_bounds)
        if lb is None or rb is None:
            return None
        return lb * rb if e.op == "*" else lb + rb
    return None


def certify_predicate(e: Optional[E.TExpr], col_bounds: list) -> bool:
    """Predicate certifiable: boolean combinations of comparisons (and
    BETWEEN lowerings) whose operands are bounded integer expressions."""
    if e is None:
        return True
    if isinstance(e, E.BinE):
        if e.op in _BOOL:
            return certify_predicate(e.left, col_bounds) and (
                certify_predicate(e.right, col_bounds)
            )
        if e.op in _CMP:
            lb = bound(e.left, col_bounds)
            rb = bound(e.right, col_bounds)
            return (
                lb is not None and rb is not None
                and lb < EXACT and rb < EXACT
            )
        return False
    if isinstance(e, E.UnaryE) and e.op == "not":
        return certify_predicate(e.operand, col_bounds)
    if isinstance(e, E.InListE):
        lb = bound(e.operand, col_bounds)
        if lb is None or lb >= EXACT:
            return False
        return all(
            isinstance(i, E.Const)
            and i.value is not None and abs(float(i.value)) < EXACT
            for i in e.items
        )
    return False


def decompose_value(e: E.TExpr, col_bounds: list):
    """The reference's admission rule for an aggregated value: a list of
    ``(sub_value, scale)`` with every sub-value bounded < 2^24, or None
    when not certifiable. A product above 2^24 is admitted when its wide
    operand X is < 2^24 and its narrow operand Y <= 4096: the reference
    limb-splits it as X*Y = 4096*(X_hi*Y) + X_lo*Y.

    The port keeps the decision and its shape (one entry, or the two
    limb entries ``("hi", x, y)`` / ``("lo", x, y)``) but evaluates the
    whole value ``e`` in int64, where no split is needed."""
    b = bound(e, col_bounds)
    if b is not None and b < EXACT:
        return [(e, 1.0)]
    if isinstance(e, E.BinE) and e.op == "*":
        for x, y in ((e.left, e.right), (e.right, e.left)):
            bx, by = bound(x, col_bounds), bound(y, col_bounds)
            if (
                bx is not None and by is not None
                and bx < EXACT and by <= LIMB
            ):
                return [(("hi", x, y), LIMB), (("lo", x, y), 1.0)]
    return None


def inline_projects(e: E.TExpr, project_chain: list) -> E.TExpr:
    """Rewrite an expression over a projected schema into one over the
    scan schema by substituting each Project step's expressions
    bottom-up. ``project_chain``: list of expr tuples, scan-side first."""
    for exprs in reversed(project_chain):
        e = _subst(e, exprs)
    return e


def _subst(e: E.TExpr, exprs) -> E.TExpr:
    if isinstance(e, E.Col):
        return exprs[e.index]
    if dataclasses.is_dataclass(e):
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, E.TExpr):
                changes[f.name] = _subst(v, exprs)
            elif isinstance(v, tuple) and v and isinstance(v[0], E.TExpr):
                changes[f.name] = tuple(_subst(x, exprs) for x in v)
        if changes:
            return dataclasses.replace(e, **changes)
    return e


GROUP_DOMAIN_CAP = 16  # max joint key domain the grouped kernel accepts


def plan_group_keys(
    key_exprs: list, col_ranges: list, cap: int = GROUP_DOMAIN_CAP
):
    """Admit GROUP BY keys into the grouped kernel when every key (after
    project inlining) is a bare column with a small host-known value
    range — TPC-H Q1's (returnflag, linestatus) shape. Returns
    (key_expr, decoders, n_groups):

    - ``key_expr``: a TExpr over the scan schema computing the joint
      dense group index in [0, D);
    - ``decoders``: per key, (col_index, min, domain, stride) so the host
      recovers each key value from a joint index (g // stride) % domain;
    - ``n_groups``: the static joint domain D <= cap.

    Raises PallasUnsupported outside this subset."""
    decoders = []
    stride = 1
    for e in key_exprs:
        if not isinstance(e, E.Col):
            raise PallasUnsupported("computed group key")
        rng = col_ranges[e.index]
        if rng is None:
            raise PallasUnsupported("unbounded group key")
        lo, hi = rng
        if abs(lo) >= EXACT or abs(hi) >= EXACT:
            # key values themselves must be f32-exact in the reference:
            # 2^24 and 2^24+1 would collapse to one f32 value there
            raise PallasUnsupported("group key beyond f32-exact bound")
        domain = hi - lo + 1
        decoders.append((e.index, lo, domain, stride))
        stride *= domain
        if stride > cap:
            raise PallasUnsupported("group domain too large")
    return key_expr_from_decoders(decoders, key_exprs), decoders, stride


def key_expr_from_decoders(decoders, key_exprs) -> E.TExpr:
    """sum((key - min) * stride) over the keys, as an INT8 TExpr."""
    joint: Optional[E.TExpr] = None
    for (_idx, lo, _domain, st), e in zip(decoders, key_exprs):
        term = E.BinE(
            "*",
            E.BinE("-", e, E.Const(int(lo), t.INT8), t.INT8),
            E.Const(int(st), t.INT8),
            t.INT8,
        )
        joint = term if joint is None else E.BinE("+", joint, term, t.INT8)
    return joint


# ---------------------------------------------------------------------------
# Expression programs: certified TExpr -> int64 stack bytecode
# ---------------------------------------------------------------------------

# opcodes; csrc/scan_agg.cu defines the same numbers
OP_COL, OP_CONST, OP_ADD, OP_SUB, OP_MUL, OP_NEG = 1, 2, 3, 4, 5, 6
OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE = 7, 8, 9, 10, 11, 12
OP_AND, OP_OR, OP_NOT = 13, 14, 15

_BINOPS = {
    "+": OP_ADD, "-": OP_SUB, "*": OP_MUL,
    "=": OP_EQ, "<>": OP_NE, "!=": OP_NE,
    "<": OP_LT, "<=": OP_LE, ">": OP_GT, ">=": OP_GE,
    "and": OP_AND, "or": OP_OR,
}

# limits of the kernel's parameter block (csrc/scan_agg.cu SA_*)
MAX_COLS = 16
MAX_CODE = 256
MAX_CONSTS = 64
MAX_VALUES = 8
MAX_STACK = 16
MAX_GROUPS = GROUP_DOMAIN_CAP


@dataclass(frozen=True)
class ScanAggSpec:
    """Everything the kernel evaluates, compiled once per query shape.

    ``code`` holds (op, arg) pairs for all programs back to back;
    ``pred``/``key`` are (start, length) into it or None (always true /
    group 0), ``values`` one (start, length) per SUM argument. ``cols``
    lists the scan-column indices the programs load, in slot order (an
    OP_COL argument is a slot)."""

    code: tuple
    consts: tuple
    cols: tuple
    pred: Optional[tuple]
    key: Optional[tuple]
    values: tuple
    n_groups: int = 1

    @property
    def n_values(self) -> int:
        return len(self.values)


class _ProgramBuilder:
    def __init__(self):
        self.code: list[tuple[int, int]] = []
        self.consts: list[int] = []
        self.cols: list[int] = []

    def program(self, e: E.TExpr) -> tuple[int, int]:
        start = len(self.code)
        depth = self._emit(e)
        if depth > MAX_STACK:
            raise PallasUnsupported("expression too deep for the kernel")
        return start, len(self.code) - start

    def _const(self, v) -> int:
        fv = float(v)
        if not fv.is_integer():
            raise PallasUnsupported("non-integer constant")
        iv = int(v)
        if iv not in self.consts:
            self.consts.append(iv)
        return self.consts.index(iv)

    def _emit(self, e: E.TExpr) -> int:
        """Append e's code; returns the stack depth it needs."""
        if isinstance(e, E.Col):
            if e.index not in self.cols:
                self.cols.append(e.index)
            self.code.append((OP_COL, self.cols.index(e.index)))
            return 1
        if isinstance(e, E.Const):
            self.code.append((OP_CONST, self._const(e.value)))
            return 1
        if isinstance(e, E.CastE):
            # integer-to-integer casts of the certified subset keep the
            # physical value (the reference's compile_f32 does the same)
            return self._emit(e.operand)
        if isinstance(e, E.UnaryE) and e.op in ("-", "not"):
            d = self._emit(e.operand)
            self.code.append((OP_NEG if e.op == "-" else OP_NOT, 0))
            return d
        if isinstance(e, E.InListE):
            depth = 0
            for i, item in enumerate(e.items):
                # from the second item on, the OR so far sits below
                below = 1 if i else 0
                d = self._emit(e.operand)
                self.code.append((OP_CONST, self._const(item.value)))
                self.code.append((OP_EQ, 0))
                depth = max(depth, below + d, below + 2)
                if i:
                    self.code.append((OP_OR, 0))
            if e.negated:
                self.code.append((OP_NOT, 0))
            return depth
        if isinstance(e, E.BinE) and e.op in _BINOPS:
            dl = self._emit(e.left)
            dr = self._emit(e.right)
            self.code.append((_BINOPS[e.op], 0))
            return max(dl, dr + 1)
        raise PallasUnsupported(type(e).__name__)


def compile_spec(
    preds: list, key_expr: Optional[E.TExpr], values: list,
    n_groups: int = 1,
) -> ScanAggSpec:
    """Compile certified scan-schema expressions into one ScanAggSpec.
    Raises PallasUnsupported when the programs exceed the kernel's
    parameter block."""
    b = _ProgramBuilder()
    pred = None
    if preds:
        p = preds[0]
        for q in preds[1:]:
            p = E.BinE("and", p, q, t.BOOL)
        pred = b.program(p)
    key = b.program(key_expr) if key_expr is not None else None
    vals = tuple(b.program(v) for v in values)
    if (
        len(b.code) > MAX_CODE or len(b.consts) > MAX_CONSTS
        or len(b.cols) > MAX_COLS or len(vals) > MAX_VALUES
        or not 1 <= n_groups <= MAX_GROUPS
    ):
        raise PallasUnsupported("query exceeds the kernel's limits")
    return ScanAggSpec(
        tuple(b.code), tuple(b.consts), tuple(b.cols), pred, key, vals,
        n_groups,
    )


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------


def _eval_program(spec: ScanAggSpec, prog, cols) -> torch.Tensor:
    start, n = prog
    stack: list = []
    consts = spec.consts
    for op, arg in spec.code[start:start + n]:
        if op == OP_COL:
            stack.append(cols[arg])
        elif op == OP_CONST:
            stack.append(consts[arg])
        elif op == OP_NEG:
            stack.append(-stack.pop())
        elif op == OP_NOT:
            stack.append(1 - stack.pop())
        else:
            r = stack.pop()
            a = stack.pop()
            if op == OP_ADD:
                v = a + r
            elif op == OP_SUB:
                v = a - r
            elif op == OP_MUL:
                v = a * r
            elif op == OP_AND:
                v = a * r
            elif op == OP_OR:
                v = (a + r) > 0
            elif op == OP_EQ:
                v = a == r
            elif op == OP_NE:
                v = a != r
            elif op == OP_LT:
                v = a < r
            elif op == OP_LE:
                v = a <= r
            elif op == OP_GT:
                v = a > r
            else:
                v = a >= r
            if isinstance(v, torch.Tensor) and v.dtype == torch.bool:
                v = v.to(torch.int64)
            elif isinstance(v, bool):
                v = int(v)
            stack.append(v)
    return stack[0]


def _row_stages(cols, xmin, xmax, nrows, snap: int, spec: ScanAggSpec):
    """The rows each stage of the kernel reaches, as [S, R] bool masks:
    ``real`` (r < nrows), ``live`` (real and visible at ``snap``),
    ``keyed`` (live and passing the predicate; the key program runs on
    these), ``counted`` (keyed with a key in [0, G); the value programs
    run on these). Also returns the int64 key [S, R] and the columns
    widened to int64."""
    S = xmin.shape[0]
    if cols:
        R = cols[0].shape[1]
    elif xmin.shape[1] > 1:
        R = xmin.shape[1]
    else:  # no column loaded and compact planes: rows are nrows alone
        R = max(int(nrows.max()) if S else 0, 1)
    dev = xmin.device
    row = torch.arange(R, device=dev)[None, :]
    real = (row < nrows[:, None]).expand(S, R)
    live = real & (xmin <= snap) & (snap < xmax)
    vals = [c.to(torch.int64) for c in cols]
    keyed = live
    if spec.pred is not None:
        keyed = live & (_eval_program(spec, spec.pred, vals) != 0)
    if spec.key is not None:
        key = _eval_program(spec, spec.key, vals) + torch.zeros(
            (S, R), dtype=torch.int64, device=dev
        )
        counted = keyed & (key >= 0) & (key < spec.n_groups)
    else:
        key = torch.zeros((S, R), dtype=torch.int64, device=dev)
        counted = keyed
    return real, live, keyed, counted, key, vals


def scan_agg_plain(cols, xmin, xmax, nrows, snap: int, spec: ScanAggSpec):
    """Plain PyTorch version of the kernel, same arguments and results:
    ``cols`` the [S, Rmax] planes of ``spec.cols`` (int32, int64 or
    bool), ``xmin``/``xmax`` int64 [S, 1] or [S, Rmax], ``nrows`` int64
    [S]. Returns int64 ``sums`` [S, G, E] and ``counts`` [S, G]."""
    _real, _live, _keyed, live, key, vals = _row_stages(
        cols, xmin, xmax, nrows, snap, spec
    )
    S, R = live.shape
    dev = xmin.device
    G, Ev = spec.n_groups, spec.n_values
    slot = (torch.arange(S, device=dev)[:, None] * G + key)[live]
    counts = torch.zeros(S * G, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, slot, torch.ones_like(slot))
    sums = torch.zeros((Ev, S * G), dtype=torch.int64, device=dev)
    for e, prog in enumerate(spec.values):
        v = _eval_program(spec, prog, vals) + torch.zeros(
            (S, R), dtype=torch.int64, device=dev
        )
        sums[e].scatter_add_(0, slot, v[live])
    return sums.T.reshape(S, G, Ev).contiguous(), counts.reshape(S, G)


SECTOR = 32  # bytes: the unit in which the card reads device memory


def sector_bytes(mask: torch.Tensor, elem: int) -> int:
    """Bytes of the 32-byte sectors of an [S, R] plane of ``elem``-byte
    entries that hold at least one row of ``mask``."""
    k = SECTOR // elem
    S, R = mask.shape
    if R % k:
        mask = torch.cat(
            [mask, mask.new_zeros((S, k - R % k))], dim=1
        )
    return int(mask.reshape(S, -1, k).any(-1).sum()) * SECTOR


def _program_slots(spec: ScanAggSpec, prog) -> set:
    if prog is None:
        return set()
    start, n = prog
    return {arg for op, arg in spec.code[start:start + n] if op == OP_COL}


def spec_bytes(cols, xmin, xmax, nrows, snap: int, spec: ScanAggSpec) -> int:
    """Bytes the scan must move at least on these inputs, counted in the
    32-byte sectors the card reads: each column the sectors holding the
    rows its first program runs on (predicate columns: every visible
    row; key columns: the rows that pass the predicate; value-only
    columns: the rows that are counted), full MVCC planes their real
    rows (xmax only where xmin <= snap) and compact ones one entry a
    shard, then nrows, and each output written once."""
    real, live, keyed, counted, _key, _vals = _row_stages(
        cols, xmin, xmax, nrows, snap, spec
    )
    pred = _program_slots(spec, spec.pred)
    key = _program_slots(spec, spec.key) - pred
    total = 0
    for i, c in enumerate(cols):
        rows = live if i in pred else keyed if i in key else counted
        total += sector_bytes(rows, c.element_size())
    S = xmin.shape[0]
    if xmin.shape[1] == 1:
        total += 2 * 8 * S
    else:
        total += sector_bytes(real, 8)
        total += sector_bytes(real & (xmin <= snap), 8)
    total += 8 * S  # nrows
    total += 8 * S * spec.n_groups * (spec.n_values + 1)
    return total


# ---------------------------------------------------------------------------
# The kernel: build, bind, launch
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.bool: 2}
THREADS = 256  # csrc/scan_agg.cu SA_THREADS
BLOCKS_PER_SM = 8


class _Params(ctypes.Structure):
    """Mirror of ``struct ScanAggParams`` in csrc/scan_agg.cu (the
    library reports its sizeof; ``_load`` checks the two agree)."""

    _fields_ = [
        ("cols", ctypes.c_void_p * MAX_COLS),
        ("xmin", ctypes.c_void_p),
        ("xmax", ctypes.c_void_p),
        ("nrows", ctypes.c_void_p),
        ("sums", ctypes.c_void_p),
        ("counts", ctypes.c_void_p),
        ("consts", ctypes.c_int64 * MAX_CONSTS),
        ("rmax", ctypes.c_int64),
        ("mvcc_shard_stride", ctypes.c_int64),
        ("mvcc_row_stride", ctypes.c_int64),
        ("snap", ctypes.c_int64),
        ("col_dtype", ctypes.c_int32 * MAX_COLS),
        ("code", ctypes.c_int32 * MAX_CODE),
        ("pred_start", ctypes.c_int32),
        ("pred_len", ctypes.c_int32),
        ("key_start", ctypes.c_int32),
        ("key_len", ctypes.c_int32),
        ("val_start", ctypes.c_int32 * MAX_VALUES),
        ("val_len", ctypes.c_int32 * MAX_VALUES),
        ("n_groups", ctypes.c_int32),
        ("n_values", ctypes.c_int32),
    ]


_lib = None
_lib_mu = threading.Lock()


def _load():
    global _lib
    with _lib_mu:
        if _lib is None:
            lib = cuda_build.load("scan_agg.cu")
            lib.scan_agg_params_size.argtypes = []
            lib.scan_agg_params_size.restype = ctypes.c_int
            lib.scan_agg_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib.scan_agg_launch.restype = ctypes.c_int
            got = lib.scan_agg_params_size()
            if got != ctypes.sizeof(_Params):
                raise RuntimeError(
                    f"ScanAggParams layout mismatch: library {got} bytes, "
                    f"python {ctypes.sizeof(_Params)}"
                )
            _lib = lib
        return _lib


def _check_args(cols, xmin, xmax, nrows, spec):
    if len(cols) != len(spec.cols):
        raise ValueError("one plane per spec column expected")
    S = xmin.shape[0]
    if xmin.shape != xmax.shape or xmin.dim() != 2:
        raise ValueError("xmin/xmax must be [S, 1] or [S, Rmax]")
    for x in (xmin, xmax, nrows):
        if x.dtype != torch.int64:
            raise TypeError("MVCC planes and nrows must be int64")
    if nrows.shape != (S,):
        raise ValueError("nrows must be [S]")
    for c in cols:
        if c.dtype not in _DTYPE_CODE:
            raise TypeError(f"unsupported column dtype {c.dtype}")
        if c.dim() != 2 or c.shape[0] != S:
            raise ValueError("column planes must be [S, Rmax]")
        if c.shape != cols[0].shape:
            raise ValueError("column planes differ in shape")


def scan_agg(cols, xmin, xmax, nrows, snap: int, spec: ScanAggSpec,
             max_nrows: Optional[int] = None):
    """Per-shard exact ``sums`` int64 [S, G, E] and ``counts`` int64
    [S, G] of the rows r < nrows[s] visible at ``snap`` that pass the
    predicate, grouped by the key program (see ``scan_agg_plain`` for
    the argument shapes). ``max_nrows`` (host int) sizes the grid; it
    defaults to the planes' width.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``scan_agg.launches``) or raise."""
    _check_args(cols, xmin, xmax, nrows, spec)
    if xmin.device.type == "cpu":
        return scan_agg_plain(cols, xmin, xmax, nrows, snap, spec)
    if xmin.device.type != "cuda":
        raise RuntimeError(f"scan_agg: no kernel for {xmin.device}")
    dev = xmin.device
    for x in (*cols, xmax, nrows):
        if x.device != dev:
            raise ValueError("scan_agg: tensors on different devices")
    cols = [c.contiguous() for c in cols]
    xmin, xmax, nrows = xmin.contiguous(), xmax.contiguous(), nrows.contiguous()
    S = xmin.shape[0]
    rmax = cols[0].shape[1] if cols else xmin.shape[1]
    if xmin.shape[1] not in (1, rmax):
        raise ValueError("MVCC planes must be [S, 1] or [S, Rmax]")
    G, Ev = spec.n_groups, spec.n_values
    sums = torch.zeros((S, G, Ev), dtype=torch.int64, device=dev)
    counts = torch.zeros((S, G), dtype=torch.int64, device=dev)
    if S == 0:
        return sums, counts
    lib = _load()
    p = _Params()
    for i, c in enumerate(cols):
        p.cols[i] = c.data_ptr()
        p.col_dtype[i] = _DTYPE_CODE[c.dtype]
    p.xmin, p.xmax, p.nrows = xmin.data_ptr(), xmax.data_ptr(), nrows.data_ptr()
    p.sums, p.counts = sums.data_ptr(), counts.data_ptr()
    for i, v in enumerate(spec.consts):
        p.consts[i] = v
    p.rmax = rmax
    compact = xmin.shape[1] == 1
    p.mvcc_shard_stride = 1 if compact else rmax
    p.mvcc_row_stride = 0 if compact else 1
    p.snap = int(snap)
    for i, (op, arg) in enumerate(spec.code):
        p.code[i] = op | (arg << 8)
    p.pred_start, p.pred_len = spec.pred if spec.pred else (0, 0)
    p.key_start, p.key_len = spec.key if spec.key else (0, 0)
    for i, (s0, n) in enumerate(spec.values):
        p.val_start[i], p.val_len[i] = s0, n
    p.n_groups, p.n_values = G, Ev
    rows = rmax if max_nrows is None else max(int(max_nrows), 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(
        -(-rows // THREADS), max(1, sms * BLOCKS_PER_SM // S)
    ))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.scan_agg_launch(ctypes.addressof(p), blocks, S, stream)
    if rc != 0:
        raise RuntimeError(f"scan_agg kernel launch failed: CUDA error {rc}")
    scan_agg.launches += 1
    return sums, counts


scan_agg.launches = 0
