"""SQL abstract syntax tree.

Compact analog of the reference's parse nodes (src/include/nodes/
parsenodes.h). Statement nodes cover the surface in SURVEY.md §2.1's DDL
table plus standard DML/queries; expression nodes are the scalar language
the expression compilers lower to device code.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

class Expr:
    __slots__ = ()


@dataclass(frozen=True)
class Literal(Expr):
    value: object  # python int/float/str/bool/None

    def __str__(self):
        if self.value is None:
            return "NULL"
        if isinstance(self.value, str):
            return "'" + self.value.replace("'", "''") + "'"
        return str(self.value)


@dataclass(frozen=True)
class ColumnRef(Expr):
    name: str
    table: Optional[str] = None  # qualifier

    def __str__(self):
        return f"{self.table}.{self.name}" if self.table else self.name


@dataclass(frozen=True)
class Param(Expr):
    index: int  # 1-based, $1

    def __str__(self):
        return f"${self.index}"


@dataclass(frozen=True)
class Star(Expr):
    table: Optional[str] = None

    def __str__(self):
        return f"{self.table}.*" if self.table else "*"


@dataclass(frozen=True)
class BinOp(Expr):
    op: str  # + - * / % = <> < <= > >= and or || like
    left: Expr
    right: Expr

    def __str__(self):
        return f"({self.left} {self.op.upper()} {self.right})"


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # - not
    operand: Expr

    def __str__(self):
        return f"({self.op.upper()} {self.operand})"


@dataclass(frozen=True)
class IsNull(Expr):
    operand: Expr
    negated: bool = False

    def __str__(self):
        return f"({self.operand} IS {'NOT ' if self.negated else ''}NULL)"


@dataclass(frozen=True)
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False

    def __str__(self):
        n = "NOT " if self.negated else ""
        return f"({self.operand} {n}BETWEEN {self.low} AND {self.high})"


@dataclass(frozen=True)
class RowExpr(Expr):
    """(a, b, ...) row constructor — exists only between the parser's
    paren handling and the IN desugaring; never reaches analysis."""

    items: tuple[Expr, ...] = ()

    def __str__(self):
        return "(" + ", ".join(map(str, self.items)) + ")"


@dataclass(frozen=True)
class InList(Expr):
    operand: Expr
    items: tuple[Expr, ...]
    negated: bool = False

    def __str__(self):
        n = "NOT " if self.negated else ""
        return f"({self.operand} {n}IN ({', '.join(map(str, self.items))}))"


@dataclass(frozen=True)
class InSubquery(Expr):
    operand: Expr
    query: "Select"
    negated: bool = False

    def __str__(self):
        n = "NOT " if self.negated else ""
        return f"({self.operand} {n}IN (<subquery>))"


@dataclass(frozen=True)
class ExistsSubquery(Expr):
    query: "Select"
    negated: bool = False

    def __str__(self):
        return f"({'NOT ' if self.negated else ''}EXISTS (<subquery>))"


@dataclass(frozen=True)
class WindowCall(Expr):
    """f(args) OVER (PARTITION BY ... ORDER BY ...) — nodeWindowAgg's
    input shape (parsenodes.h WindowFunc + WindowClause)."""

    func: "FuncCall"
    partition_by: tuple = ()
    order_by: tuple = ()  # tuple[SortItem, ...]
    # ROWS frame: (start, end) with None = unbounded, negative =
    # k PRECEDING, 0 = CURRENT ROW, positive = k FOLLOWING
    frame: "Optional[tuple]" = None

    def __str__(self):
        return f"{self.func} OVER (...)"


@dataclass(frozen=True)
class ScalarSubquery(Expr):
    query: "Select"

    def __str__(self):
        return "(<scalar subquery>)"


@dataclass(frozen=True)
class FuncCall(Expr):
    name: str
    args: tuple[Expr, ...]
    distinct: bool = False  # COUNT(DISTINCT x)
    star: bool = False  # COUNT(*)

    def __str__(self):
        if self.star:
            return f"{self.name}(*)"
        d = "DISTINCT " if self.distinct else ""
        return f"{self.name}({d}{', '.join(map(str, self.args))})"


@dataclass(frozen=True)
class Cast(Expr):
    operand: Expr
    type_name: str
    type_args: tuple[int, ...] = ()

    def __str__(self):
        return f"CAST({self.operand} AS {self.type_name})"


@dataclass(frozen=True)
class CaseExpr(Expr):
    # CASE [operand] WHEN cond THEN val ... [ELSE default] END
    operand: Optional[Expr]
    whens: tuple[tuple[Expr, Expr], ...]
    default: Optional[Expr]

    def __str__(self):
        parts = ["CASE"]
        if self.operand is not None:
            parts.append(str(self.operand))
        for c, v in self.whens:
            parts.append(f"WHEN {c} THEN {v}")
        if self.default is not None:
            parts.append(f"ELSE {self.default}")
        parts.append("END")
        return " ".join(parts)


@dataclass(frozen=True)
class Extract(Expr):
    field_name: str  # year month day hour ...
    operand: Expr

    def __str__(self):
        return f"EXTRACT({self.field_name.upper()} FROM {self.operand})"


# ---------------------------------------------------------------------------
# Table references (FROM clause)
# ---------------------------------------------------------------------------

class TableRef:
    __slots__ = ()


@dataclass(frozen=True)
class RelRef(TableRef):
    name: str
    alias: Optional[str] = None


@dataclass(frozen=True)
class SubqueryRef(TableRef):
    query: "Select"
    alias: str


@dataclass(frozen=True)
class JoinRef(TableRef):
    join_type: str  # inner | left | right | full | cross
    left: TableRef
    right: TableRef
    condition: Optional[Expr] = None  # ON ...; None for CROSS
    using: tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------

class Statement:
    __slots__ = ()


@dataclass(frozen=True)
class SortItem:
    expr: Expr
    descending: bool = False
    nulls_first: Optional[bool] = None  # None = default (last for ASC)


@dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass
class Select(Statement):
    items: list[SelectItem]
    from_clause: Optional[TableRef] = None
    where: Optional[Expr] = None
    group_by: list[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: list[SortItem] = field(default_factory=list)
    limit: Optional[Expr] = None
    offset: Optional[Expr] = None
    distinct: bool = False
    # set operation chain: ("union"|"union all"|"intersect"|"except", Select)
    set_ops: list[tuple[str, "Select"]] = field(default_factory=list)
    # row locking: FOR UPDATE / FOR SHARE [NOWAIT] (top level only)
    for_update: Optional[str] = None
    lock_nowait: bool = False
    # WITH clause: [(name, column_aliases, Select)] — statement-scoped
    # views, expanded by plan/views.py expand_ctes before analysis
    ctes: list = field(default_factory=list)
    # standalone VALUES (...), (...) rows; items is empty then
    values_rows: list = field(default_factory=list)
    # DISTINCT ON (exprs) — desugared by the parser into a
    # row_number() window over a derived table
    distinct_on: Optional[list] = None
    # GROUP BY ROLLUP/CUBE/GROUPING SETS — list of grouping sets
    # (tuples of exprs); desugared by the parser into UNION ALL
    grouping_sets: Optional[list] = None
    # WITH RECURSIVE was written: self-referencing CTEs are
    # materialized iteratively by the engine before analysis
    ctes_recursive: bool = False


@dataclass
class Insert(Statement):
    table: str
    columns: list[str]  # empty = all, in table order
    values: list[list[Expr]]  # VALUES rows
    query: Optional[Select] = None  # INSERT ... SELECT
    returning: list[SelectItem] = field(default_factory=list)
    # ON CONFLICT [(col)] DO NOTHING | DO UPDATE SET ...:
    # (target_col|None, "nothing"|"update", [(col, Expr)])
    on_conflict: Optional[tuple] = None


@dataclass
class Update(Statement):
    table: str
    assignments: list[tuple[str, Expr]]
    where: Optional[Expr] = None
    returning: list[SelectItem] = field(default_factory=list)
    alias: Optional[str] = None
    # UPDATE ... FROM source: (table name, alias|None)
    from_table: Optional[tuple] = None


@dataclass
class Delete(Statement):
    table: str
    where: Optional[Expr] = None
    returning: list[SelectItem] = field(default_factory=list)
    alias: Optional[str] = None
    # DELETE ... USING source: (table name, alias|None)
    from_table: Optional[tuple] = None


@dataclass(frozen=True)
class ColumnDef:
    name: str
    type_name: str
    type_args: tuple[int, ...] = ()
    not_null: bool = False
    primary_key: bool = False
    default: Optional[Expr] = None


@dataclass
class CreateTable(Statement):
    name: str
    columns: list[ColumnDef]
    # DISTRIBUTE BY {SHARD(col) | HASH(col) | MODULO(col) | REPLICATION | ROUNDROBIN}
    distribute_strategy: Optional[str] = None
    distribute_keys: list[str] = field(default_factory=list)
    to_group: Optional[str] = None  # TO GROUP name
    if_not_exists: bool = False
    # PARTITION BY RANGE (col) BEGIN (ts) STEP (interval) PARTITIONS (n) — the
    # reference's interval partitioning (gram.y:4172)
    partition_by: Optional[dict] = None


@dataclass
class SavepointStmt(Statement):
    name: str


@dataclass
class RollbackToSavepoint(Statement):
    name: str


@dataclass
class ReleaseSavepoint(Statement):
    name: str


@dataclass
class PrepareStmt(Statement):
    """PREPARE name AS statement (prepare.c / the extended-protocol Parse
    message)."""

    name: str
    statement: Statement


@dataclass
class ExecuteStmt(Statement):
    name: str
    args: list = field(default_factory=list)  # list[Expr]


@dataclass
class DeallocateStmt(Statement):
    name: Optional[str] = None  # None = ALL


@dataclass
class CreateView(Statement):
    name: str
    query: "Select"
    text: str = ""  # verbatim body source (pg_get_viewdef)
    replace: bool = False


@dataclass
class DropView(Statement):
    name: str
    if_exists: bool = False


@dataclass
class CreateMatview(Statement):
    """CREATE MATERIALIZED VIEW name [WITH (distribute = ...,
    incremental = on|off)] AS select — matview.c's DDL surface plus
    the incremental-maintenance and distribution knobs (matview/)."""

    name: str
    query: "Select"
    text: str = ""  # verbatim body source (durable definition)
    options: dict = field(default_factory=dict)
    if_not_exists: bool = False


@dataclass
class RefreshMatview(Statement):
    """REFRESH MATERIALIZED VIEW [CONCURRENTLY] name (matview.c's
    ExecRefreshMatView; CONCURRENTLY overlaps readers)."""

    name: str
    concurrently: bool = False


@dataclass
class DropMatview(Statement):
    name: str
    if_exists: bool = False
    cascade: bool = False


@dataclass
class CreateTableAs(Statement):
    name: str
    query: "Select"
    if_not_exists: bool = False


@dataclass
class AlterTable(Statement):
    """ALTER TABLE: schema evolution + online redistribution (the XL
    ALTER TABLE ... DISTRIBUTE BY path, redistrib.c) + interval-partition
    extension."""

    table: str
    action: str  # distribute | add_partitions | add_column | drop_column
    strategy: Optional[str] = None
    keys: list = field(default_factory=list)
    count: int = 0
    column: Optional[ColumnDef] = None
    column_name: Optional[str] = None


@dataclass
class DropTable(Statement):
    names: list[str]
    if_exists: bool = False
    # CASCADE drops dependent views/materialized views instead of
    # refusing with SQLSTATE 2BP01 (dependent_objects_still_exist)
    cascade: bool = False


@dataclass
class TruncateTable(Statement):
    names: list[str]


@dataclass
class CreateForeignTable(Statement):
    name: str
    columns: list["ColumnDef"]
    server: str
    options: dict = field(default_factory=dict)


@dataclass
class CreateUser(Statement):
    name: str
    password: str
    alter: bool = False  # ALTER USER ... PASSWORD


@dataclass
class DropUser(Statement):
    name: str
    if_exists: bool = False


@dataclass
class CreateIndex(Statement):
    name: str
    table: str
    columns: list[str]
    unique: bool = False


@dataclass
class CopyStmt(Statement):
    table: str
    columns: list[str]
    direction: str  # 'from' | 'to'
    target: str  # filename or STDIN/STDOUT
    options: dict = field(default_factory=dict)  # csv, delimiter, header...


# -- transactions -----------------------------------------------------------

@dataclass
class BeginStmt(Statement):
    isolation: Optional[str] = None


@dataclass
class CommitStmt(Statement):
    pass


@dataclass
class RollbackStmt(Statement):
    pass


@dataclass
class PrepareTransaction(Statement):
    gid: str


@dataclass
class CommitPrepared(Statement):
    gid: str


@dataclass
class RollbackPrepared(Statement):
    gid: str


# -- cluster DDL (the XL grammar surface, gram.y:307-313 etc.) --------------

@dataclass
class CreateNode(Statement):
    name: str
    node_type: str  # coordinator | datanode | gtm
    host: str = "localhost"
    port: int = 0
    is_primary: bool = False
    is_preferred: bool = False


@dataclass
class AlterNode(Statement):
    name: str
    options: dict = field(default_factory=dict)


@dataclass
class DropNode(Statement):
    name: str


@dataclass
class CreateNodeGroup(Statement):
    name: str
    members: list[str] = field(default_factory=list)
    kind: str = "hot"  # CREATE NODE GROUP ... WITH (...) [COLD|HOT]


@dataclass
class DropNodeGroup(Statement):
    name: str


@dataclass
class CreateShardingGroup(Statement):
    members: list[str] = field(default_factory=list)  # node names; empty = all


@dataclass
class CleanSharding(Statement):
    pass


@dataclass
class MoveData(Statement):
    # MOVE DATA FROM node TO node [SHARDS (...)]
    from_node: str = ""
    to_node: str = ""
    shard_ids: list[int] = field(default_factory=list)


@dataclass
class AlterCluster(Statement):
    # ALTER CLUSTER ADD NODE n [WITH (...)] [WAIT]
    # ALTER CLUSTER REMOVE NODE n [WAIT]
    # ALTER CLUSTER REBALANCE [WAIT]
    action: str  # add_node | remove_node | rebalance
    name: str = ""
    options: dict = field(default_factory=dict)
    wait: bool = False  # block until the background rebalance finishes


@dataclass
class CreateBarrier(Statement):
    barrier_id: Optional[str] = None


@dataclass
class PauseCluster(Statement):
    pass


@dataclass
class UnpauseCluster(Statement):
    pass


@dataclass
class ExecuteDirect(Statement):
    nodes: list[str]
    query: Statement


@dataclass
class CreateSequence(Statement):
    name: str
    start: int = 1
    increment: int = 1
    if_not_exists: bool = False


@dataclass
class DropSequence(Statement):
    name: str
    if_exists: bool = False


# -- misc -------------------------------------------------------------------

@dataclass
class ExplainStmt(Statement):
    query: Statement
    analyze: bool = False
    verbose: bool = False


@dataclass
class VacuumStmt(Statement):
    table: Optional[str] = None


@dataclass
class CreateFunction(Statement):
    """CREATE [OR REPLACE] FUNCTION name(arg type, ...) RETURNS type
    AS '<sql body>' LANGUAGE SQL (functioncmds.c + SQL-function
    inlining). The body is a SELECT; FROM-less single-expression bodies
    inline as expressions, table-reading bodies as scalar subqueries."""

    name: str
    args: list[tuple[str, str]]  # (arg name, type name)
    rettype: str
    body: str
    replace: bool = False
    language: str = "sql"  # 'sql' | 'plpgsql'


@dataclass
class DropFunction(Statement):
    name: str
    if_exists: bool = False


@dataclass
class CreatePublication(Statement):
    """CREATE PUBLICATION name FOR ALL TABLES | FOR TABLE t1 [, ...]
    [ON NODE (dn, ...)] — node list = shard-filtered publication
    (pg_publication_shard)."""

    name: str
    tables: Optional[list[str]] = None  # None = FOR ALL TABLES
    nodes: Optional[list[str]] = None


@dataclass
class DropPublication(Statement):
    name: str


@dataclass
class CreateSubscription(Statement):
    """CREATE SUBSCRIPTION name CONNECTION 'host=.. port=..'
    PUBLICATION pub [WITH (copy_data = on|off)]."""

    name: str
    conninfo: str
    publication: str
    copy_data: bool = True


@dataclass
class DropSubscription(Statement):
    name: str


@dataclass
class AuditStmt(Statement):
    """AUDIT <kind> [ON rel] [BY user] [WHENEVER [NOT] SUCCESSFUL]
    (gram.y:11189, Oracle-style audit DDL)."""

    kind: str  # all|select|insert|update|delete|copy|ddl
    relation: Optional[str] = None
    db_user: Optional[str] = None
    whenever: str = "all"  # all | successful | not successful


@dataclass
class NoAuditStmt(Statement):
    kind: str
    relation: Optional[str] = None
    db_user: Optional[str] = None


@dataclass
class CreateResourceGroup(Statement):
    """CREATE/ALTER RESOURCE GROUP name WITH (concurrency=N,
    memory_limit='64MB', queue_depth=N, priority=N) — the workload
    management DDL surface (wlm/)."""

    name: str
    options: dict = field(default_factory=dict)
    alter: bool = False


@dataclass
class DropResourceGroup(Statement):
    name: str
    if_exists: bool = False


@dataclass
class AlterRoleResourceGroup(Statement):
    """ALTER ROLE r RESOURCE GROUP g | ALTER ROLE r NO RESOURCE GROUP
    (group None = unbind)."""

    role: str
    group: Optional[str] = None


@dataclass
class LockTable(Statement):
    """LOCK [TABLE] name [IN <mode> MODE] [NOWAIT] (lockcmds.c)."""

    table: str
    mode: Optional[str] = None
    nowait: bool = False


@dataclass
class SetStmt(Statement):
    name: str
    value: object


@dataclass
class ShowStmt(Statement):
    name: str


@dataclass
class AnalyzeStmt(Statement):
    table: Optional[str] = None


AnyExpr = Union[Expr]
