"""Fused scan -> WHERE -> SUM/COUNT per shard: the Hopper kernel that
replaces the reference's Pallas kernel (opentenbase_tpu/ops/pallas_scan.py,
``build_partials`` + ``combine_partials``).

Four parts:

- the certifier, copied from the reference (``bound``,
  ``certify_predicate``, ``decompose_value``, ``plan_group_keys``,
  ``inline_projects``): it decides which queries take the kernel, so the
  port admits exactly the queries the reference admits;
- an expression-program compiler: certified TExprs become a flat int64
  bytecode (column load, constant, ``+ - *``, unary ``-``, the six
  comparisons, ``and or not``; IN-lists lower to ORs of ``=``). One
  program for the predicate, one for the dense group key, one per SUM
  argument;
- the kernel's host side: ``kernel_code`` lowers a spec to the one
  program the kernel runs over a tile (filters, folded constants, a
  stack slot per word), ``launch_plan`` picks the kernel instance, the
  tile and the number of staged tiles, ``decode_program`` turns the
  words into the records of the kernel's parameter block;
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
    OP_COL argument is a slot).

    ``slots`` gives, per entry of ``code``, the stack slot its result
    lands in (the stack height after it, less one: a push writes the
    slot above the top, a unary op the top, a binary op the slot below
    the top), so the kernel needs no stack pointer; ``pred_depth``,
    ``key_depth`` and ``value_depths`` are each program's deepest
    stack."""

    code: tuple
    consts: tuple
    cols: tuple
    pred: Optional[tuple]
    key: Optional[tuple]
    values: tuple
    n_groups: int = 1
    slots: tuple = ()
    pred_depth: int = 0
    key_depth: int = 0
    value_depths: tuple = ()

    @property
    def n_values(self) -> int:
        return len(self.values)


_STACK_EFFECT = {OP_COL: 1, OP_CONST: 1, OP_NEG: 0, OP_NOT: 0}  # else -1


class _ProgramBuilder:
    def __init__(self):
        self.code: list[tuple[int, int]] = []
        self.slots: list[int] = []
        self.consts: list[int] = []
        self.cols: list[int] = []
        self._sp = 0
        self._deepest = 0

    def program(self, e: E.TExpr) -> tuple[tuple[int, int], int]:
        """Append e's program; returns ((start, length), deepest stack)."""
        start = len(self.code)
        self._sp = self._deepest = 0
        self._emit(e)
        if self._deepest > MAX_STACK:
            raise PallasUnsupported("expression too deep for the kernel")
        return (start, len(self.code) - start), self._deepest

    def _op(self, op: int, arg: int = 0) -> None:
        self._sp += _STACK_EFFECT.get(op, -1)
        self._deepest = max(self._deepest, self._sp)
        self.code.append((op, arg))
        self.slots.append(self._sp - 1)

    def _const(self, v) -> int:
        fv = float(v)
        if not fv.is_integer():
            raise PallasUnsupported("non-integer constant")
        iv = int(v)
        if iv not in self.consts:
            self.consts.append(iv)
        return self.consts.index(iv)

    def _emit(self, e: E.TExpr) -> None:
        if isinstance(e, E.Col):
            if e.index not in self.cols:
                self.cols.append(e.index)
            self._op(OP_COL, self.cols.index(e.index))
        elif isinstance(e, E.Const):
            self._op(OP_CONST, self._const(e.value))
        elif isinstance(e, E.CastE):
            # integer-to-integer casts of the certified subset keep the
            # physical value (the reference's compile_f32 does the same)
            self._emit(e.operand)
        elif isinstance(e, E.UnaryE) and e.op in ("-", "not"):
            self._emit(e.operand)
            self._op(OP_NEG if e.op == "-" else OP_NOT)
        elif isinstance(e, E.InListE):
            for i, item in enumerate(e.items):
                self._emit(e.operand)
                self._op(OP_CONST, self._const(item.value))
                self._op(OP_EQ)
                if i:
                    self._op(OP_OR)
            if e.negated:
                self._op(OP_NOT)
        elif isinstance(e, E.BinE) and e.op in _BINOPS:
            self._emit(e.left)
            self._emit(e.right)
            self._op(_BINOPS[e.op])
        else:
            raise PallasUnsupported(type(e).__name__)


def compile_spec(
    preds: list, key_expr: Optional[E.TExpr], values: list,
    n_groups: int = 1,
) -> ScanAggSpec:
    """Compile certified scan-schema expressions into one ScanAggSpec.
    Raises PallasUnsupported when the programs exceed the kernel's
    parameter block."""
    b = _ProgramBuilder()
    pred, pred_depth = None, 0
    if preds:
        p = preds[0]
        for q in preds[1:]:
            p = E.BinE("and", p, q, t.BOOL)
        pred, pred_depth = b.program(p)
    key, key_depth = (
        b.program(key_expr) if key_expr is not None else (None, 0)
    )
    vals = [b.program(v) for v in values]
    if (
        len(b.code) > MAX_CODE or len(b.consts) > MAX_CONSTS
        or len(b.cols) > MAX_COLS or len(vals) > MAX_VALUES
        or not 1 <= n_groups <= MAX_GROUPS
    ):
        raise PallasUnsupported("query exceeds the kernel's limits")
    return ScanAggSpec(
        tuple(b.code), tuple(b.consts), tuple(b.cols), pred, key,
        tuple(v for v, _d in vals), n_groups, tuple(b.slots), pred_depth,
        key_depth, tuple(d for _v, d in vals),
    )


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------


def _eval_program(spec: ScanAggSpec, prog, cols, heights=None):
    """Run one program over the widened columns; with ``heights`` (a
    list), append the stack height after each instruction to it."""
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
        if heights is not None:
            heights.append(len(stack))
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


def column_classes(spec: ScanAggSpec) -> tuple[list, list]:
    """(staged, gathered) column slots: the slots the predicate or key
    program loads are staged tile by tile for every row; the rest (read
    by value programs only) are gathered where a row is counted."""
    staged = _program_slots(spec, spec.pred) | _program_slots(spec, spec.key)
    gathered = [i for i in range(len(spec.cols)) if i not in staged]
    return sorted(staged), gathered


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
# The kernel: lowering, launch plan, build, bind, launch
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.bool: 2}
# kernel-only opcodes (csrc/scan_agg.cu), each over the thread's rows:
# (OP_PASS, OP_KEY and OP_ACC read slot 0)
OP_PASS = 16   # rows whose slot 0 is 0 stop passing
OP_KEY = 17    # slot 0 is the group; rows outside [0, G) stop passing
OP_COUNT = 18  # count the passing rows; a warp with none stops here
OP_ACC = 19    # add slot 0 to value lane ``arg`` of the row's group
OP_ANY = 20    # a warp with no passing row stops here
OP_ACCN = 21   # count the passing rows and add slots 0..E-1 to lanes 0..E-1
OP_GCOL = 22   # OP_COL of a gathered column: read where a row passes
OP_K = 32      # OP_K + binop: slot = slot binop consts[arg]
OP_FILT = 64   # OP_FILT + cmp: rows failing column[aux] cmp consts[arg]
#                stop passing (a conjunct of the predicate)
MAX_KCODE = MAX_CODE + MAX_VALUES + 3  # csrc/scan_agg.cu SA_MAX_KCODE
# (stack depth, rows per thread) of the kernel's instances: the stack
# lives in depth x rows 64-bit registers
VARIANTS = ((4, 8), (8, 4), (16, 2))
THREADS = 256  # csrc/scan_agg.cu SA_THREADS: a block
SMEM_BLOCK_MAX = 232448  # 227 KB: the most shared memory a block can use
# two blocks a multiprocessor: each takes half of its 228 KB, less the
# 1 KB the runtime reserves per block
SMEM_HALF_SM = 233472 // 2 - 1024
SMEM_HEAD = 128  # the stages' mbarriers and thread 0's walk, before them
NARROW = 4  # csrc/scan_agg.cu SA_NARROW: a filter compares in 32 bits
ACC_PRIVATE_MAX = 48 * 1024  # per-thread accumulator lanes up to this

_CMPS = (OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE)
# c op x == x op' c: the comparison with its operands swapped
_SWAP = {OP_EQ: OP_EQ, OP_NE: OP_NE, OP_LT: OP_GT, OP_LE: OP_GE,
         OP_GT: OP_LT, OP_GE: OP_LE, OP_ADD: OP_ADD, OP_MUL: OP_MUL,
         OP_AND: OP_AND, OP_OR: OP_OR}
# x op c == x when c is this constant: the op is left out
_IDENTITY = {OP_ADD: 0, OP_SUB: 0, OP_MUL: 1}


def _variant(depth: int) -> tuple[int, int]:
    for d, k in VARIANTS:
        if depth <= d:
            return d, k
    raise PallasUnsupported("expression too deep for the kernel")


def _word(op: int, arg: int = 0, slot: int = 0, aux: int = 0) -> int:
    return op | arg << 8 | slot << 16 | aux << 24


def _tree(spec: ScanAggSpec, prog) -> tuple:
    """A program's postfix code as a tree: ("col", slot), ("const",
    index), (unary op, child) or (binary op, left, right)."""
    start, n = prog
    st: list = []
    for op, arg in spec.code[start:start + n]:
        if op == OP_COL:
            st.append(("col", arg))
        elif op == OP_CONST:
            st.append(("const", arg))
        elif op in (OP_NEG, OP_NOT):
            st.append((op, st.pop()))
        else:
            b = st.pop()
            st.append((op, st.pop(), b))
    return st[0]


class _Emitter:
    """Tree -> kernel words with the slot of every result: the operand
    of a binary op with a constant folds into an OP_K word (x + 0, x - 0
    and x * 1 vanish), other operands take the slot above; a gathered
    column is loaded by OP_GCOL."""

    def __init__(self, consts, gathered):
        self.consts = consts
        self.gathered = gathered
        self.words: list[int] = []
        self.depth = 0

    def emit(self, node, s: int) -> None:
        self.depth = max(self.depth, s + 1)
        kind = node[0]
        if kind == "col":
            op = OP_GCOL if node[1] in self.gathered else OP_COL
            self.words.append(_word(op, node[1], s))
        elif kind == "const":
            self.words.append(_word(OP_CONST, node[1], s))
        elif len(node) == 2:
            self.emit(node[1], s)
            self.words.append(_word(kind, 0, s))
        else:
            op, a, b = node
            if a[0] == "const" and b[0] != "const" and op in _SWAP:
                op, a, b = _SWAP[op], b, a
            if b[0] == "const":
                self.emit(a, s)
                if self.consts[b[1]] != _IDENTITY.get(op):
                    self.words.append(_word(OP_K + op, b[1], s))
            else:
                self.emit(a, s)
                self.emit(b, s + 1)
                self.words.append(_word(op, 0, s))


def _conjuncts(node) -> list:
    if node[0] == OP_AND:
        return _conjuncts(node[1]) + _conjuncts(node[2])
    return [node]


def kernel_code(spec: ScanAggSpec) -> tuple[list, int, int]:
    """The kernel's one program over a tile, as words ``op | arg << 8 |
    slot << 16 | aux << 24``: the predicate's conjuncts (a column
    compared with a constant is one OP_FILT; any other conjunct is
    evaluated and applied by OP_PASS), the key then OP_KEY, and the
    value programs with their accumulation. Returns (words, stack depth,
    rows a thread).

    When the instance's depth allows, value program e keeps its slots
    above slot e ("stacked"): OP_ANY, the programs, then one OP_ACCN
    that counts the rows and adds every value, so every gathered load of
    the tile is issued before the first one is used and a row's lanes
    are found once. Otherwise OP_COUNT, then each program followed by
    its own OP_ACC from slot 0."""
    gathered = set(column_classes(spec)[1])
    em = _Emitter(spec.consts, gathered)
    if spec.pred is not None:
        for c in _conjuncts(_tree(spec, spec.pred)):
            op = c[0]
            if op in _CMPS and c[1][0] == "const" and c[2][0] == "col":
                op, c = _SWAP[op], (op, c[2], c[1])
            if op in _CMPS and c[1][0] == "col" and c[2][0] == "const":
                em.words.append(_word(OP_FILT + op, c[2][1], 0, c[1][1]))
            else:
                em.emit(c, 0)
                em.words.append(_word(OP_PASS))
    if spec.key is not None:
        em.emit(_tree(spec, spec.key), 0)
        em.words.append(_word(OP_KEY))
    head, flat = em.words, em.depth
    trees = [_tree(spec, v) for v in spec.values]
    per = []
    for tr in trees:
        e = _Emitter(spec.consts, gathered)
        e.emit(tr, 0)
        per.append(e)
    flat = max([flat, *(e.depth for e in per)])
    depth, rows = _variant(flat)
    stacked = max((i + e.depth for i, e in enumerate(per)), default=0)
    words = list(head)
    if stacked <= depth:
        words.append(_word(OP_ANY))
        for i, tr in enumerate(trees):
            e = _Emitter(spec.consts, gathered)
            e.emit(tr, i)
            words += e.words
        words.append(_word(OP_ACCN, len(trees)))
    else:
        words.append(_word(OP_COUNT))
        for i, e in enumerate(per):
            words += e.words + [_word(OP_ACC, i, 0)]
    return words, depth, rows


@dataclass(frozen=True)
class LaunchPlan:
    """How one spec runs: ``depth``/``rows`` pick the instance, a tile
    is ``THREADS * rows`` rows, ``stages`` tiles are staged ahead in
    shared memory, ``col_smem`` is each column slot's byte offset in a
    stage (-1: gathered from device memory), ``xmin_smem``/``xmax_smem``
    those of full MVCC planes (-1: compact), ``acc_private`` selects
    per-thread accumulator lanes (else per-warp lanes with shared-memory
    atomics). The kernel's launch fills the card with as many blocks as
    fit at once."""

    depth: int
    rows: int
    stages: int
    stage_bytes: int
    col_smem: tuple
    xmin_smem: int
    xmax_smem: int
    acc_private: bool
    smem_bytes: int

    @property
    def tile(self) -> int:
        return THREADS * self.rows


def _round(n: int, q: int) -> int:
    return -(-n // q) * q


def launch_plan(spec: ScanAggSpec, widths, mvcc_full: bool) -> LaunchPlan:
    """Pick the instance and the number of stages for ``spec`` whose
    column slots are ``widths`` bytes wide: the shallowest instance deep
    enough (its tile is the largest), then the most stages, that let two
    blocks share a multiprocessor, else one block with all of its 227 KB;
    a deeper instance, with fewer rows a thread, where the tile does not
    fit."""
    _words, depth, _rows = kernel_code(spec)
    staged, _gathered = column_classes(spec)
    lanes = spec.n_groups * (spec.n_values + 1)
    private = lanes * THREADS * 8 <= ACC_PRIVATE_MAX
    acc = lanes * (THREADS if private else THREADS // 32) * 8
    for d, rows in VARIANTS:
        if d < depth:
            continue
        T = THREADS * rows
        offs, off = {}, 0
        for c in staged:
            offs[c] = off
            off += _round(T * widths[c], 128)
        xmin_off = xmax_off = -1
        if mvcc_full:
            xmin_off, xmax_off = off, off + T * 8
            off += 2 * T * 8
        for budget, stages in ((SMEM_HALF_SM, 3), (SMEM_HALF_SM, 2),
                               (SMEM_BLOCK_MAX, 3), (SMEM_BLOCK_MAX, 2)):
            smem = SMEM_HEAD + stages * off + acc
            if smem <= budget:
                return LaunchPlan(
                    d, rows, stages, off,
                    tuple(offs.get(i, -1) for i in range(len(widths))),
                    xmin_off, xmax_off, private, smem,
                )
    raise PallasUnsupported("no tile fits the kernel's shared memory")


def decode_program(words, consts, col_smem, col_dtype, col_addr) -> list:
    """The kernel's words as the records it runs (``struct Ins``):
    (op, slot, stage offset, type or lane, value). A column's stage
    offset, type and, when gathered, plane address come from the launch;
    the value is the word's constant; a filter of a 4- or 1-byte column
    by a constant within int32 compares in 32 bits."""
    out = []
    for w in words:
        op, arg, slot, aux = w & 0xff, w >> 8 & 0xff, w >> 16 & 0xff, w >> 24
        off = dtype = v = 0
        if op in (OP_COL, OP_GCOL) or op >= OP_FILT:
            c = aux if op >= OP_FILT else arg
            off, dtype = col_smem[c], col_dtype[c]
            if op == OP_GCOL:
                v = col_addr[c]
        if op == OP_CONST or op >= OP_K:
            v = consts[arg]
        if op >= OP_FILT and dtype != 1 and -2**31 <= v < 2**31:
            dtype |= NARROW
        if op in (OP_ACC, OP_ACCN):
            dtype = arg
        out.append((op, slot, off, dtype, v))
    return out


class _Ins(ctypes.Structure):
    """Mirror of ``struct Ins`` in csrc/scan_agg.cu."""

    _fields_ = [
        ("op", ctypes.c_int32),
        ("slot", ctypes.c_int32),
        ("off", ctypes.c_int32),
        ("dtype", ctypes.c_int32),
        ("v", ctypes.c_int64),
    ]


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
        ("rmax", ctypes.c_int64),
        ("row_cap", ctypes.c_int64),
        ("snap", ctypes.c_int64),
        ("tiles_per_shard", ctypes.c_int32),
        ("n_shards", ctypes.c_int32),
        ("col_dtype", ctypes.c_int32 * MAX_COLS),
        ("col_smem", ctypes.c_int32 * MAX_COLS),
        ("prog", _Ins * MAX_KCODE),
        ("code_len", ctypes.c_int32),
        ("n_groups", ctypes.c_int32),
        ("n_values", ctypes.c_int32),
        ("xmin_smem", ctypes.c_int32),
        ("xmax_smem", ctypes.c_int32),
        ("stage_bytes", ctypes.c_int32),
        ("n_stages", ctypes.c_int32),
        ("acc_private", ctypes.c_int32),
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
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p,
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


def _padded(x: torch.Tensor, R: int) -> torch.Tensor:
    """``x`` [S, R0] zero-padded to [S, R] (rows past every nrows)."""
    if x.shape[1] == R:
        return x.contiguous()
    y = torch.zeros((x.shape[0], R), dtype=x.dtype, device=x.device)
    y[:, :x.shape[1]] = x
    return y


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its base on the 16-byte boundary bulk copies need."""
    return x.clone() if x.data_ptr() % 16 else x


def scan_agg(cols, xmin, xmax, nrows, snap: int, spec: ScanAggSpec,
             max_nrows: Optional[int] = None):
    """Per-shard exact ``sums`` int64 [S, G, E] and ``counts`` int64
    [S, G] of the rows r < nrows[s] visible at ``snap`` that pass the
    predicate, grouped by the key program (see ``scan_agg_plain`` for
    the argument shapes). ``max_nrows`` (host int, at least every
    nrows[s]) sizes the grid; it defaults to the planes' width.

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
    S = xmin.shape[0]
    R = cols[0].shape[1] if cols else xmin.shape[1]
    full = xmin.shape[1] != 1
    if full and xmin.shape[1] != R:
        raise ValueError("MVCC planes must be [S, 1] or [S, Rmax]")
    G, Ev = spec.n_groups, spec.n_values
    sums = torch.zeros((S, G, Ev), dtype=torch.int64, device=dev)
    counts = torch.zeros((S, G), dtype=torch.int64, device=dev)
    if S == 0:
        return sums, counts
    widths = [c.element_size() for c in cols]
    plan = launch_plan(spec, widths, full)
    # every plane row starts on a 16-byte boundary: R a multiple of 16
    rmax = _round(R, 16)
    cols = [_padded(c, rmax) for c in cols]
    if full:
        xmin, xmax = _aligned(_padded(xmin, rmax)), _aligned(
            _padded(xmax, rmax))
    else:
        xmin, xmax = xmin.contiguous(), xmax.contiguous()
    staged = column_classes(spec)[0]
    cols = [_aligned(c) if i in staged else c for i, c in enumerate(cols)]
    nrows = nrows.contiguous()
    if cols or full:
        row_cap = span = R
        rows = R if max_nrows is None else min(int(max_nrows), R)
    else:  # nothing loaded, compact planes: the rows are nrows alone
        row_cap, span = 2**62, max(int(nrows.max()), 1)
        rows = span
    words = kernel_code(spec)[0]
    lib = _load()
    p = _Params()
    for i in range(MAX_COLS):
        p.col_smem[i] = -1
    for i, c in enumerate(cols):
        p.cols[i] = c.data_ptr()
        p.col_dtype[i] = _DTYPE_CODE[c.dtype]
        p.col_smem[i] = plan.col_smem[i]
    p.xmin, p.xmax, p.nrows = xmin.data_ptr(), xmax.data_ptr(), nrows.data_ptr()
    p.sums, p.counts = sums.data_ptr(), counts.data_ptr()
    p.rmax, p.row_cap, p.snap = rmax, row_cap, int(snap)
    T = plan.tile
    tiles = -(-span // T)
    if S * tiles >= 2**31:
        raise ValueError("scan_agg: 2^31 tiles or more")
    p.tiles_per_shard, p.n_shards = tiles, S
    prog = decode_program(words, spec.consts, plan.col_smem,
                          [_DTYPE_CODE[c.dtype] for c in cols],
                          [c.data_ptr() for c in cols])
    for i, rec in enumerate(prog):
        p.prog[i] = _Ins(*rec)
    p.code_len = len(prog)
    p.n_groups, p.n_values = G, Ev
    p.xmin_smem, p.xmax_smem = plan.xmin_smem, plan.xmax_smem
    p.stage_bytes, p.n_stages = plan.stage_bytes, plan.stages
    p.acc_private = int(plan.acc_private)
    max_grid = max(1, S * -(-rows // T))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.scan_agg_launch(ctypes.addressof(p), plan.depth,
                                 plan.rows, max_grid, plan.smem_bytes,
                                 stream)
    if rc != 0:
        raise RuntimeError(f"scan_agg kernel launch failed: CUDA error {rc}")
    scan_agg.launches += 1
    return sums, counts


scan_agg.launches = 0
