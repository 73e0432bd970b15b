"""SQL type system, designed for TPU residency.

The reference carries PostgreSQL's full type system (src/backend/utils/adt).
We keep a compact core that covers the analytic + transactional surface and
maps every type onto a TPU-friendly physical representation:

- BOOL      -> bool_
- INT2/4    -> int32
- INT8      -> int64
- FLOAT4    -> float32
- FLOAT8    -> float32 on device (TPU has no native f64; sums that need
               exactness use integer paths), float64 host-side.
- DECIMAL   -> scaled int64 ("decimal cents"); exact arithmetic via integer
               ops, which the TPU executes without the f64 penalty.
- DATE      -> int32 days since 1970-01-01 (same epoch trick as PG's jdate).
- TIMESTAMP -> int64 microseconds since epoch.
- TEXT      -> int32 dictionary codes + a host-side dictionary. String
               predicates (LIKE, =, <) are evaluated once against the
               dictionary on host, producing a code-set the device tests
               membership against — the string never reaches HBM.

NULLs are a separate validity bitmask (True = valid), as in Arrow, rather
than PG's per-tuple null bitmap (src/include/access/htup_details.h).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class TypeId(enum.Enum):
    BOOL = "bool"
    INT4 = "int4"
    INT8 = "int8"
    FLOAT4 = "float4"
    FLOAT8 = "float8"
    DECIMAL = "decimal"
    DATE = "date"
    TIMESTAMP = "timestamp"
    TEXT = "text"


@dataclass(frozen=True)
class SqlType:
    """A SQL type instance. ``scale`` only meaningful for DECIMAL."""

    id: TypeId
    precision: int = 0
    scale: int = 0

    # ---- physical representation ------------------------------------
    @property
    def np_dtype(self) -> np.dtype:
        return _NP_DTYPES[self.id]

    @property
    def is_integer(self) -> bool:
        return self.id in (TypeId.INT4, TypeId.INT8)

    @property
    def is_numeric(self) -> bool:
        return self.id in (
            TypeId.INT4,
            TypeId.INT8,
            TypeId.FLOAT4,
            TypeId.FLOAT8,
            TypeId.DECIMAL,
        )

    @property
    def is_text(self) -> bool:
        return self.id == TypeId.TEXT

    @property
    def decimal_factor(self) -> int:
        """10**scale for DECIMAL; 1 otherwise."""
        return 10 ** self.scale if self.id == TypeId.DECIMAL else 1

    def __str__(self) -> str:
        if self.id == TypeId.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        return self.id.value


_NP_DTYPES = {
    TypeId.BOOL: np.dtype(np.bool_),
    TypeId.INT4: np.dtype(np.int32),
    TypeId.INT8: np.dtype(np.int64),
    TypeId.FLOAT4: np.dtype(np.float32),
    TypeId.FLOAT8: np.dtype(np.float64),
    TypeId.DECIMAL: np.dtype(np.int64),
    TypeId.DATE: np.dtype(np.int32),
    TypeId.TIMESTAMP: np.dtype(np.int64),
    TypeId.TEXT: np.dtype(np.int32),  # dictionary codes
}

BOOL = SqlType(TypeId.BOOL)
INT4 = SqlType(TypeId.INT4)
INT8 = SqlType(TypeId.INT8)
FLOAT4 = SqlType(TypeId.FLOAT4)
FLOAT8 = SqlType(TypeId.FLOAT8)
DATE = SqlType(TypeId.DATE)
TIMESTAMP = SqlType(TypeId.TIMESTAMP)
TEXT = SqlType(TypeId.TEXT)


def decimal(precision: int, scale: int) -> SqlType:
    return SqlType(TypeId.DECIMAL, precision, scale)


# ---------------------------------------------------------------------------
# Type name parsing (the slice of PG's pg_type lookup we need)
# ---------------------------------------------------------------------------

_NAME_ALIASES = {
    "bool": BOOL,
    "boolean": BOOL,
    "int2": INT4,
    "smallint": INT4,
    "int": INT4,
    "int4": INT4,
    "integer": INT4,
    "int8": INT8,
    "bigint": INT8,
    "float4": FLOAT4,
    "real": FLOAT4,
    "float8": FLOAT8,
    "float": FLOAT8,
    "double": FLOAT8,
    "date": DATE,
    "timestamp": TIMESTAMP,
    "timestamptz": TIMESTAMP,
    "text": TEXT,
    "varchar": TEXT,
    "char": TEXT,
    "bpchar": TEXT,
    "name": TEXT,
}


def type_from_name(name: str, args: tuple[int, ...] = ()) -> SqlType:
    """Resolve a SQL type name (+ optional typmod args) to a SqlType."""
    name = name.lower()
    if name in ("decimal", "numeric"):
        precision = args[0] if args else 18
        scale = args[1] if len(args) > 1 else 0
        return decimal(precision, scale)
    if name in _NAME_ALIASES:
        return _NAME_ALIASES[name]
    raise ValueError(f"unknown type name: {name!r}")


# ---------------------------------------------------------------------------
# Implicit coercion lattice (parse_coerce.c equivalent, radically simplified)
# ---------------------------------------------------------------------------

_NUMERIC_RANK = {
    TypeId.INT4: 0,
    TypeId.INT8: 1,
    TypeId.DECIMAL: 2,
    TypeId.FLOAT4: 3,
    TypeId.FLOAT8: 4,
}


def common_numeric_type(a: SqlType, b: SqlType) -> SqlType:
    """The common type two numeric operands are coerced to."""
    if not (a.is_numeric and b.is_numeric):
        raise TypeError(f"no common numeric type for {a} and {b}")
    if a.id == TypeId.DECIMAL and b.id == TypeId.DECIMAL:
        scale = max(a.scale, b.scale)
        return decimal(max(a.precision, b.precision), scale)
    ra, rb = _NUMERIC_RANK[a.id], _NUMERIC_RANK[b.id]
    return a if ra >= rb else b
