# ported from tidb_tpu/sql/parser.py @ 9d319cb
"""Recursive-descent SQL parser (MySQL-dialect subset).

Reference analog: pkg/parser (goyacc grammar parser.y, 17k lines).  The TPU
rebuild uses a hand-written Pratt/recursive-descent parser over the subset
the engine executes: SELECT (joins/group/having/order/limit, subqueries in
FROM), INSERT/UPDATE/DELETE, CREATE/DROP TABLE/DATABASE, EXPLAIN [ANALYZE],
SHOW, SET, BEGIN/COMMIT/ROLLBACK, TRUNCATE, ANALYZE TABLE.

Operator precedence mirrors MySQL: OR < XOR < AND < NOT < comparison/IN/
BETWEEN/LIKE/IS < bitor < bitand < shift < add < mul < unary.
"""

from __future__ import annotations

from typing import Optional

from . import ast as A
from .lexer import Token, tokenize


class ParseError(ValueError):
    def __init__(self, msg: str, tok: Token):
        super().__init__(f"{msg} near {tok.text!r} (pos {tok.pos})")
        self.tok = tok


class Parser:
    def __init__(self, sql: str):
        toks = tokenize(sql)
        # hint comments are only meaningful right after SELECT; anywhere
        # else they behave like ordinary comments (dropped), so SQL such
        # as `UPDATE /*+ x */ t SET ...` still parses
        self.toks = [t for j, t in enumerate(toks)
                     if t.kind != "hint"
                     or (j > 0 and toks[j - 1].kind == "kw"
                         and toks[j - 1].text == "SELECT")]
        self.i = 0
        self.sql = sql           # raw text (binding statement capture)

    def _stmt_text_until(self, stop_kw) -> str:
        """Raw SQL text of an embedded statement, from the current token
        up to `stop_kw` (a top-level keyword followed by SELECT/WITH —
        distinguishes binding USING from join USING) or end-of-statement.
        Advances past the captured tokens."""
        start = self.cur.pos
        j = self.i
        while j < len(self.toks):
            t = self.toks[j]
            if t.kind == "eof" or (t.kind == "op" and t.text == ";"):
                break
            if (stop_kw and t.kind == "kw" and t.text == stop_kw
                    and j + 1 < len(self.toks)
                    and self.toks[j + 1].kind == "kw"
                    and self.toks[j + 1].text in ("SELECT", "WITH")):
                break
            j += 1
        end = self.toks[j].pos if j < len(self.toks) else len(self.sql)
        self.i = j
        return self.sql[start:end].strip()

    # ---------------- token helpers ---------------- #

    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def advance(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        return self.cur.kind == "kw" and self.cur.text in kws

    def at_op(self, *ops: str) -> bool:
        return self.cur.kind == "op" and self.cur.text in ops

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.advance()
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.advance()
            return True
        return False

    def expect_kw(self, kw: str) -> Token:
        if not self.at_kw(kw):
            raise ParseError(f"expected {kw}", self.cur)
        return self.advance()

    def expect_op(self, op: str) -> Token:
        if not self.at_op(op):
            raise ParseError(f"expected {op!r}", self.cur)
        return self.advance()

    def ident(self) -> str:
        t = self.cur
        if t.kind == "ident":
            return self.advance().text
        # non-reserved keywords usable as identifiers
        if t.kind == "kw" and t.text in _NONRESERVED:
            return self.advance().text
        raise ParseError("expected identifier", t)

    # ---------------- entry ---------------- #

    def parse(self) -> list[A.Node]:
        stmts = []
        while self.cur.kind != "eof":
            if self.accept_op(";"):
                continue
            start = self.cur.pos
            node = self.statement()
            end = self.cur.pos        # pos of ';' or eof token
            node.text_span = (start, end)
            stmts.append(node)
            if self.cur.kind != "eof":
                self.expect_op(";")
        return stmts

    def statement(self) -> A.Node:
        if self.at_kw("SELECT", "WITH") or self.at_op("("):
            return self.select_query()
        # TRACE is non-reserved (MySQL-compatible): match contextually,
        # only when followed by a statement-starting keyword
        if (self.cur.kind == "ident" and self.cur.text.upper() == "TRACE"
                and self.toks[self.i + 1].kind == "kw"):
            self.advance()
            return A.TraceStmt(self.statement())
        if self.at_kw("EXPLAIN", "DESCRIBE"):
            self.advance()
            if (self.cur.kind == "ident"
                    and self.cur.text.upper() == "FORMAT"
                    and self.toks[self.i + 1].text == "="):
                self.advance()      # EXPLAIN FORMAT = 'brief'|'row'|...
                self.expect_op("=")
                (self._str_lit() if self.cur.kind == "str"
                 else self.ident())
            # DESCRIBE <table> = SHOW COLUMNS FROM <table>
            elif self.cur.kind == "ident" \
                    and self.toks[self.i + 1].text != "(":
                return A.ShowStmt("columns", self.ident())
            analyze = self.accept_kw("ANALYZE")
            return A.Explain(self.statement(), analyze)
        if self.at_kw("CREATE"):
            return self.create_stmt()
        if self.at_kw("ALTER"):
            return self.alter_stmt()
        if self.at_kw("DROP"):
            return self.drop_stmt()
        if self.at_kw("INSERT"):
            return self.insert_stmt()
        if self.at_kw("REPLACE"):
            return self.insert_stmt(replace=True)
        if self.at_kw("LOAD"):
            return self.load_data_stmt()
        if self.at_kw("UPDATE"):
            return self.update_stmt()
        if self.at_kw("DELETE"):
            return self.delete_stmt()
        if (self.cur.kind in ("kw", "ident")
                and self.cur.text.upper() == "KILL"):
            self.advance()
            query_only = True
            if self._accept_word("QUERY"):
                query_only = True
            elif self._accept_word("CONNECTION"):
                query_only = False
            elif self._accept_word("TIDB"):
                self._accept_word("QUERY") or self._accept_word(
                    "CONNECTION")
            return A.KillStmt(self._int_lit(), query_only)
        if self.at_kw("USE"):
            self.advance()
            return A.UseDatabase(self.ident())
        if self.at_kw("SHOW"):
            return self.show_stmt()
        if self.at_kw("SET"):
            return self.set_stmt()
        if self.at_kw("BEGIN"):
            self.advance()
            mode = ""
            if self.cur.kind == "ident" and self.cur.text.upper() in (
                    "PESSIMISTIC", "OPTIMISTIC"):
                mode = self.advance().text.lower()
            return A.TxnStmt("begin", mode)
        if self.at_kw("START"):
            self.advance()
            self.expect_kw("TRANSACTION")
            return A.TxnStmt("begin")
        if self.at_kw("COMMIT"):
            self.advance()
            return A.TxnStmt("commit")
        if self.at_kw("ROLLBACK"):
            self.advance()
            return A.TxnStmt("rollback")
        if self.at_kw("TRUNCATE"):
            self.advance()
            self.accept_kw("TABLE")
            return A.TruncateTable(self.ident())
        if self.at_kw("ANALYZE"):
            self.advance()
            self.expect_kw("TABLE")
            an = A.AnalyzeTable(self.ident())
            if self._accept_word("PREDICATE"):
                if not self._accept_word("COLUMNS"):
                    raise ParseError("expected COLUMNS after PREDICATE",
                                     self.cur)
                an.predicate_columns = True
            elif self._accept_word("COLUMNS"):
                an.columns = [self.ident()]
                while self.accept_op(","):
                    an.columns.append(self.ident())
            if self.accept_kw("WITH"):
                t = self.advance()
                if t.kind not in ("int", "float", "decimal"):
                    raise ParseError("expected a sample rate", t)
                if not self._accept_word("SAMPLERATE"):
                    raise ParseError("expected SAMPLERATE", self.cur)
                an.sample_rate = float(t.text)
            return an
        if self.cur.kind == "ident" and self.cur.text.upper() in (
                "PREPARE", "EXECUTE", "DEALLOCATE"):
            return self._prepare_family()
        if self.cur.kind == "ident" and self.cur.text.upper() == "PLAN":
            self.advance()
            if not self._accept_word("REPLAYER"):
                raise ParseError("expected REPLAYER after PLAN", self.cur)
            if not self._accept_word("DUMP"):
                raise ParseError("expected DUMP", self.cur)
            self.expect_kw("EXPLAIN")
            return A.PlanReplayerDump(self._stmt_text_until(None))
        if self.cur.kind == "ident" and self.cur.text.upper() == "SPLIT":
            self.advance()
            self.expect_kw("TABLE")
            name = self.ident()
            t = self.cur
            if not (t.kind == "ident" and t.text.upper() == "REGIONS"):
                raise ParseError("expected REGIONS", t)
            self.advance()
            return A.SplitTable(name, self._int_lit())
        if self.at_kw("ADMIN"):
            return self.admin_stmt()
        if self.at_kw("GRANT"):
            return self.grant_stmt()
        if self.at_kw("REVOKE"):
            return self.revoke_stmt()
        if self.at_kw("FLUSH"):
            self.advance()
            self.expect_kw("PRIVILEGES")
            return A.FlushStmt("privileges")
        raise ParseError("unsupported statement", self.cur)

    def admin_stmt(self) -> A.AdminStmt:
        self.expect_kw("ADMIN")
        if self.accept_kw("SHOW"):
            # ADMIN SHOW DDL JOBS
            t = self.cur
            if t.kind == "ident" and t.text.upper() == "DDL":
                self.advance()
                t2 = self.cur
                if t2.kind == "ident" and t2.text.upper() == "JOBS":
                    self.advance()
                    return A.AdminStmt("show ddl jobs")
                raise ParseError("expected JOBS after ADMIN SHOW DDL", t2)
            raise ParseError("unsupported ADMIN SHOW", t)
        if self.accept_kw("CHECK"):
            self.expect_kw("TABLE")
            return A.AdminStmt("check table", self.ident())
        if self.cur.kind == "ident" and self.cur.text.upper() == "RECOMMEND":
            self.advance()
            self.expect_kw("INDEX")
            return A.AdminStmt("recommend index")
        if self.cur.kind == "ident" and self.cur.text.upper() == "CHECKSUM":
            self.advance()
            self.expect_kw("TABLE")
            return A.AdminStmt("checksum table", self.ident())
        raise ParseError("unsupported ADMIN", self.cur)

    def _prepare_family(self) -> A.Node:
        word = self.advance().text.upper()
        if word == "PREPARE":
            name = self.ident()
            self.expect_kw("FROM")
            t = self.cur
            if t.kind != "str":
                raise ParseError("expected statement string", t)
            self.advance()
            return A.PrepareStmt(name, t.text)
        if word == "EXECUTE":
            name = self.ident()
            using: list[str] = []
            if self.at_kw("USING"):
                self.advance()
                while True:
                    self.expect_op("@")
                    using.append(self.ident())
                    if not self.accept_op(","):
                        break
            return A.ExecutePrepared(name, using)
        # DEALLOCATE PREPARE name
        if self.cur.kind == "ident" and self.cur.text.upper() == "PREPARE":
            self.advance()
        return A.DeallocateStmt(self.ident())

    # ---------------- users & privileges ---------------- #

    def _user_spec(self) -> A.UserSpec:
        t = self.cur
        if t.kind == "str":
            name = self.advance().text
        else:
            name = self.ident()
        host = "%"
        if self.accept_op("@"):
            t = self.cur
            host = self.advance().text if t.kind == "str" else self.ident()
        return A.UserSpec(name, host)

    def _user_password_list(self):
        out = []
        while True:
            spec = self._user_spec()
            pwd = None
            if self.accept_kw("IDENTIFIED"):
                self.expect_kw("BY")
                t = self.cur
                if t.kind != "str":
                    raise ParseError("expected password string", t)
                pwd = self.advance().text
            out.append((spec, pwd))
            if not self.accept_op(","):
                return out

    def _priv_list(self) -> list[str]:
        privs = []
        if self.accept_kw("ALL"):
            self.accept_kw("PRIVILEGES")
            return ["ALL"]
        while True:
            t = self.cur
            if t.kind not in ("kw", "ident"):
                raise ParseError("expected privilege", t)
            name = self.advance().text.upper()
            if name == "CREATE" and self.accept_kw("USER"):
                name = "CREATE USER"
            privs.append(name)
            if not self.accept_op(","):
                return privs

    def _priv_level(self) -> tuple[str, str]:
        """db.table | db.* | *.* | * (current db) | table"""
        if self.accept_op("*"):
            if self.accept_op("."):
                self.expect_op("*")
                return "*", "*"
            # bare '*' is MySQL's current-database level, NOT global
            return "", "*"
        name = self.ident()
        if self.accept_op("."):
            if self.accept_op("*"):
                return name, "*"
            return name, self.ident()
        return "", name      # current-db table

    def grant_stmt(self) -> A.GrantStmt:
        self.expect_kw("GRANT")
        privs = self._priv_list()
        self.expect_kw("ON")
        db, table = self._priv_level()
        self.expect_kw("TO")
        users = [self._user_spec()]
        while self.accept_op(","):
            users.append(self._user_spec())
        return A.GrantStmt(privs, db, table, users)

    def revoke_stmt(self) -> A.RevokeStmt:
        self.expect_kw("REVOKE")
        privs = self._priv_list()
        self.expect_kw("ON")
        db, table = self._priv_level()
        self.expect_kw("FROM")
        users = [self._user_spec()]
        while self.accept_op(","):
            users.append(self._user_spec())
        return A.RevokeStmt(privs, db, table, users)

    # ---------------- SELECT / set operations / WITH ---------------- #

    def select_query(self) -> A.Node:
        """Full query: [WITH [RECURSIVE] ...] select-expr with UNION/
        EXCEPT/INTERSECT chains (INTERSECT binds tighter, like MySQL 8)."""
        ctes: list[A.CTE] = []
        recursive = False
        if self.at_kw("WITH"):
            ctes, recursive = self.with_clause()
        node = self._set_op_expr()
        if ctes:  # don't clobber a parenthesized inner query's own WITH list
            node.ctes = ctes + node.ctes
            node.recursive = recursive or node.recursive
        return node

    def with_clause(self) -> tuple[list[A.CTE], bool]:
        self.expect_kw("WITH")
        recursive = self.accept_kw("RECURSIVE")
        ctes = []
        while True:
            name = self.ident()
            cols: list[str] = []
            if self.accept_op("("):
                cols.append(self.ident())
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
            self.expect_kw("AS")
            self.expect_op("(")
            sel = self.select_query()
            self.expect_op(")")
            ctes.append(A.CTE(name, cols, sel))
            if not self.accept_op(","):
                break
        return ctes, recursive

    def _set_op_expr(self) -> A.Node:
        """UNION/EXCEPT level (lowest precedence).  A trailing ORDER BY /
        LIMIT consumed by the last non-parenthesized operand is hoisted to
        the whole set operation (MySQL semantics); an intermediate operand
        carrying one is an error ("incorrect usage of UNION and ORDER BY")."""
        left, leaf = self._intersect_chain()
        while self.at_kw("UNION", "EXCEPT"):
            kind = self.advance().text.lower()
            all_ = self.accept_kw("ALL")
            if not all_:
                self.accept_kw("DISTINCT")
            self._no_trailing(leaf)
            right, leaf = self._intersect_chain()
            left = A.SetOpStmt(kind, all_, left, right)
        if isinstance(left, A.SetOpStmt):
            if leaf is not None and (leaf.order_by or leaf.limit is not None):
                left.order_by, leaf.order_by = leaf.order_by, []
                left.limit, left.offset = leaf.limit, leaf.offset
                leaf.limit = leaf.offset = None
            self._trailing_order_limit(left)
        elif leaf is None:
            # single parenthesized select: (SELECT ...) ORDER BY ... LIMIT n
            self._trailing_order_limit(left)
        return left

    def _intersect_chain(self):
        left, leaf = self._set_operand()
        while self.at_kw("INTERSECT"):
            self.advance()
            all_ = self.accept_kw("ALL")
            if not all_:
                self.accept_kw("DISTINCT")
            self._no_trailing(leaf)
            right, leaf = self._set_operand()
            left = A.SetOpStmt("intersect", all_, left, right)
        return left, leaf

    def _set_operand(self):
        """One operand: a SELECT, or a parenthesized query (whose ORDER BY/
        LIMIT stay local).  Returns (node, hoistable_leaf_or_None)."""
        if self.accept_op("("):
            inner = self.select_query()
            self.expect_op(")")
            return inner, None
        sel = self.select_stmt()
        return sel, sel

    def _no_trailing(self, leaf):
        if leaf is not None and (leaf.order_by or leaf.limit is not None):
            raise ParseError("incorrect usage of UNION and ORDER BY/LIMIT "
                             "(parenthesize the operand)", self.cur)

    def _order_by_list(self) -> list[tuple[A.Node, bool]]:
        """expr [ASC|DESC] {, ...} — caller consumed ORDER BY."""
        out = []
        while True:
            e = self.expr()
            desc = False
            if self.accept_kw("DESC"):
                desc = True
            else:
                self.accept_kw("ASC")
            out.append((e, desc))
            if not self.accept_op(","):
                break
        return out

    def _limit_clause(self) -> tuple[int, Optional[int]]:
        """n | off, n | n OFFSET off — caller consumed LIMIT."""
        a = self._int_lit()
        if self.accept_op(","):
            return self._int_lit(), a
        if self.accept_kw("OFFSET"):
            return a, self._int_lit()
        return a, None

    def _trailing_order_limit(self, node: A.Node):
        """ORDER BY / LIMIT after a parenthesized final operand."""
        if self.at_kw("ORDER") and not node.order_by:
            self.advance()
            self.expect_kw("BY")
            node.order_by = self._order_by_list()
        if node.limit is None and self.accept_kw("LIMIT"):
            node.limit, node.offset = self._limit_clause()

    def select_stmt(self) -> A.SelectStmt:
        self.expect_kw("SELECT")
        s = A.SelectStmt()
        if self.cur.kind == "hint":
            s.hints = _parse_hints(self.advance().text)
        if self.accept_kw("DISTINCT"):
            s.distinct = True
        else:
            self.accept_kw("ALL")
        while True:
            s.items.append(self.select_item())
            if not self.accept_op(","):
                break
        if self.accept_kw("FROM"):
            s.from_ = self.table_refs()
        if self.accept_kw("WHERE"):
            s.where = self.expr()
        if self.at_kw("GROUP"):
            self.advance()
            self.expect_kw("BY")
            while True:
                s.group_by.append(self.expr())
                if not self.accept_op(","):
                    break
            if self.accept_kw("WITH"):
                # only WITH ROLLUP may follow a GROUP BY list
                if not self._accept_word("ROLLUP"):
                    raise ParseError("expected ROLLUP after WITH", self.cur)
                s.rollup = True
        if self.accept_kw("HAVING"):
            s.having = self.expr()
        if self.at_kw("ORDER"):
            self.advance()
            self.expect_kw("BY")
            s.order_by = self._order_by_list()
        if self.accept_kw("LIMIT"):
            s.limit, s.offset = self._limit_clause()
        if self.at_kw("FOR"):
            # FOR UPDATE | FOR SHARE [NOWAIT]: locking read clause
            self.advance()
            if self.accept_kw("UPDATE"):
                s.for_update = True
            elif self._accept_word("SHARE"):
                s.for_update = False   # share locks are a no-op here
            else:
                raise ParseError("expected UPDATE or SHARE after FOR",
                                 self.cur)
            self._accept_word("NOWAIT")
        elif self._accept_word("LOCK"):
            self.expect_kw("IN")
            self._accept_word("SHARE")
            if not self.accept_kw("MODE"):
                self._accept_word("MODE")
        return s

    def _int_lit(self) -> int:
        t = self.cur
        if t.kind != "int":
            raise ParseError("expected integer", t)
        self.advance()
        return int(t.text)

    def _str_lit(self) -> str:
        t = self.cur
        if t.kind != "str":
            raise ParseError("expected string literal", t)
        self.advance()
        return t.text

    def select_item(self) -> A.SelectItem:
        if self.at_op("*"):
            self.advance()
            return A.SelectItem(A.Star())
        # t.* lookahead
        if (self.cur.kind == "ident" and self.toks[self.i + 1].kind == "op"
                and self.toks[self.i + 1].text == "."
                and self.toks[self.i + 2].kind == "op"
                and self.toks[self.i + 2].text == "*"):
            t = self.advance().text
            self.advance()
            self.advance()
            return A.SelectItem(A.Star(table=t))
        e = self.expr()
        alias = None
        if self.accept_kw("AS"):
            alias = self._alias_name()
        elif self.cur.kind == "ident" or (self.cur.kind == "kw"
                                          and self.cur.text in _NONRESERVED):
            alias = self.ident()
        elif self.cur.kind == "str":
            alias = self.advance().text
        return A.SelectItem(e, alias)

    def _alias_name(self) -> str:
        if self.cur.kind == "str":
            return self.advance().text
        return self.ident()

    # ---------------- FROM / joins ---------------- #

    def table_refs(self) -> A.Node:
        left = self.table_ref()
        while True:
            if self.accept_op(","):
                right = self.table_ref()
                left = A.Join("cross", left, right, None)
                continue
            kind = None
            if self.at_kw("JOIN", "INNER", "CROSS"):
                if self.accept_kw("INNER") or self.accept_kw("CROSS"):
                    pass
                self.expect_kw("JOIN")
                kind = "inner"
            elif self.at_kw("LEFT", "RIGHT"):
                side = self.advance().text.lower()
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
                kind = side
            else:
                break
            right = self.table_ref()
            on = None
            using = None
            if self.accept_kw("ON"):
                on = self.expr()
            elif self.accept_kw("USING"):
                self.expect_op("(")
                using = [self.ident()]
                while self.accept_op(","):
                    using.append(self.ident())
                self.expect_op(")")
            if kind == "inner" and on is None and using is None:
                kind = "cross"
            left = A.Join(kind, left, right, on, using)
        return left

    def table_ref(self) -> A.Node:
        if self.accept_op("("):
            if self.at_kw("SELECT", "WITH"):
                sub = self.select_query()
                self.expect_op(")")
                self.accept_kw("AS")
                return A.SubqueryRef(sub, self.ident())
            inner = self.table_refs()
            self.expect_op(")")
            return inner
        name = self.ident()
        db = None
        if self.accept_op("."):
            db, name = name, self.ident()
        as_of = None
        if (self.at_kw("AS") and self.i + 1 < len(self.toks)
                and self.toks[self.i + 1].kind in ("kw", "ident")
                and self.toks[self.i + 1].text.upper() == "OF"):
            # stale read: t AS OF TIMESTAMP <literal>
            self.advance()   # AS
            self.advance()   # OF
            if not (self.cur.kind in ("kw", "ident")
                    and self.cur.text.upper() == "TIMESTAMP"):
                raise ParseError("expected TIMESTAMP after AS OF", self.cur)
            self.advance()
            t = self.advance()
            if t.kind in ("int", "decimal", "float"):
                as_of = int(float(t.text))
            elif t.kind == "str":
                as_of = t.text
            else:
                raise ParseError("AS OF TIMESTAMP needs a literal", t)
        alias = None
        if self.accept_kw("AS"):
            alias = self.ident()
        elif self.cur.kind == "ident" and self.cur.text.upper() not in (
                "USE", "IGNORE", "FORCE"):
            alias = self.ident()
        tn = A.TableName(name, db, alias, as_of)
        # index hints: t USE|IGNORE|FORCE INDEX|KEY (ix, ...)
        while (self.cur.kind in ("kw", "ident")
               and self.cur.text.upper() in ("USE", "IGNORE", "FORCE")):
            kind = self.advance().text.lower()
            if not (self.accept_kw("INDEX") or self.accept_kw("KEY")
                    or self._accept_word("INDEX")
                    or self._accept_word("KEY")):
                raise ParseError(f"expected INDEX after {kind.upper()}",
                                 self.cur)
            names = self._paren_name_list()
            tn.index_hints.append((kind, names))
        return tn

    # ---------------- DDL ---------------- #

    def create_stmt(self) -> A.Node:
        self.expect_kw("CREATE")
        if self.at_kw("GLOBAL", "SESSION", "BINDING"):
            scope = "session"       # TiDB default scope is SESSION
            if self.at_kw("GLOBAL", "SESSION"):
                scope = self.advance().text.lower()
            self.expect_kw("BINDING")
            self.expect_kw("FOR")
            orig = self._stmt_text_until("USING")
            self.expect_kw("USING")
            bind = self._stmt_text_until(None)
            return A.CreateBinding(scope, orig, bind)
        if self.cur.kind == "ident" and self.cur.text.upper() == "RESOURCE":
            self.advance()
            self.expect_kw("GROUP")
            ine = self._if_not_exists()
            return self._resource_group_body(self.ident().lower(), ine,
                                             False)
        if self.accept_kw("DATABASE"):
            ine = self._if_not_exists()
            return A.CreateDatabase(self.ident(), ine)
        if self.accept_kw("USER"):
            ine = self._if_not_exists()
            return A.CreateUser(self._user_password_list(), ine)
        or_replace = False
        if self.accept_kw("OR"):
            if not (self.at_kw("REPLACE")
                    or (self.cur.kind == "ident"
                        and self.cur.text.upper() == "REPLACE")):
                raise ParseError("expected REPLACE after CREATE OR",
                                 self.cur)
            self.advance()
            or_replace = True
        if self.cur.kind == "ident" and self.cur.text.upper() == "VIEW":
            self.advance()
            name = self.ident()
            cols: list = []
            if self.at_op("("):
                cols = self._paren_name_list()
            self.expect_kw("AS")
            sql = self._stmt_text_until(None)
            parse_sql(sql)                 # validate the view body NOW
            return A.CreateView(name, cols, sql, or_replace)
        if or_replace:
            raise ParseError("expected VIEW after CREATE OR REPLACE",
                             self.cur)
        unique = self.accept_kw("UNIQUE")
        if self.accept_kw("INDEX") or (unique and self.accept_kw("KEY")):
            ine = self._if_not_exists()
            name = self.ident()
            self.expect_kw("ON")
            table = self.ident()
            dbq = None
            if self.accept_op("."):
                dbq, table = table, self.ident()
            cols = self._paren_name_list()
            return A.CreateIndex(name, table, dbq, cols, unique, ine)
        if unique:
            raise ParseError("expected INDEX after CREATE UNIQUE", self.cur)
        if self._accept_word("SEQUENCE"):
            return self._create_sequence()
        temporary = self._accept_word("TEMPORARY")
        self.expect_kw("TABLE")
        ine = self._if_not_exists()
        name = self.ident()
        db = None
        if self.accept_op("."):
            db, name = name, self.ident()
        self.expect_op("(")
        ct = A.CreateTable(name, db=db, if_not_exists=ine,
                           temporary=temporary)
        while True:
            if self.at_kw("PRIMARY"):
                self.advance()
                self.expect_kw("KEY")
                self.expect_op("(")
                ct.primary_key = [self.ident()]
                while self.accept_op(","):
                    ct.primary_key.append(self.ident())
                self.expect_op(")")
            elif self.at_kw("UNIQUE", "INDEX", "KEY"):
                uniq = self.accept_kw("UNIQUE")
                if not self.accept_kw("INDEX"):
                    self.accept_kw("KEY")
                iname = None
                if self.cur.kind == "ident":
                    iname = self.ident()
                cols = self._paren_name_list()
                ct.indexes.append((iname, cols, uniq))
            elif (self.cur.kind in ("kw", "ident")
                  and self.cur.text.upper() in ("CONSTRAINT", "FOREIGN")):
                fname = None
                if self._accept_word("CONSTRAINT"):
                    if self.cur.kind == "ident" \
                            and self.cur.text.upper() != "FOREIGN":
                        fname = self.ident()
                if not self._accept_word("FOREIGN"):
                    raise ParseError("expected FOREIGN KEY", self.cur)
                self.expect_kw("KEY")
                if self.cur.kind == "ident":   # optional index name
                    self.ident()
                cols = self._paren_name_list()
                if len(cols) != 1:
                    raise ParseError(
                        "only single-column FOREIGN KEY supported",
                        self.cur)
                ct.foreign_keys.append(self._references_clause(
                    fname, cols[0]))
            else:
                cd = self.column_def()
                ct.columns.append(cd)
                if cd.references is not None:
                    rt, rc, od = cd.references
                    ct.foreign_keys.append(A.ForeignKeyDef(
                        None, cd.name, rt, rc, od))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        # table options: TTL is honored, the rest (ENGINE=, CHARSET=...)
        # are accepted and ignored
        while not (self.at_op(";") or self.cur.kind == "eof"):
            if self.cur.kind == "ident" and self.cur.text.upper() == "TTL":
                self.advance()
                self.expect_op("=")
                col = self.ident()
                self.expect_op("+")
                self.expect_kw("INTERVAL")
                n = self._int_lit()
                unit = self.advance().text.upper()
                secs = {"SECOND": 1, "MINUTE": 60, "HOUR": 3600,
                        "DAY": 86400, "WEEK": 7 * 86400,
                        "MONTH": 30 * 86400, "YEAR": 365 * 86400}.get(unit)
                if secs is None:
                    raise ParseError("bad TTL unit", self.cur)
                if ct.ttl is None:
                    ct.ttl = A.TTLOption(col, n * secs)
                else:
                    ct.ttl.column, ct.ttl.interval_sec = col, n * secs
            elif (self.cur.kind in ("kw", "ident")
                  and self.cur.text.upper() == "PARTITION"):
                self.advance()
                self.expect_kw("BY")
                ct.partition = self._partition_spec()
            elif (self.cur.kind == "ident"
                  and self.cur.text.upper() == "TTL_ENABLE"):
                self.advance()
                self.expect_op("=")
                t = self.advance()   # 'ON' / 'OFF' string literal
                if ct.ttl is None:
                    ct.ttl = A.TTLOption()
                ct.ttl.enable = t.text.upper() != "OFF"
            else:
                self.advance()
        for c in ct.columns:
            if c.primary_key and c.name not in ct.primary_key:
                ct.primary_key.append(c.name)
        return ct

    def _accept_word(self, w: str) -> bool:
        """Accept a keyword OR identifier spelled `w` (non-reserved words
        like HASH/MAXVALUE lex as idents)."""
        if self.cur.kind in ("kw", "ident") and self.cur.text.upper() == w:
            self.advance()
            return True
        return False

    def _partition_spec(self) -> A.PartitionSpec:
        """RANGE (col) (PARTITION p VALUES LESS THAN (n|MAXVALUE), ...)
        | HASH (col) PARTITIONS n   (parser.y PartitionOpt subset;
        bounds are integer literals — the meta-model keeps them as ints)."""
        if self._accept_word("RANGE"):
            self.expect_op("(")
            col = self.ident()
            self.expect_op(")")
            self.expect_op("(")
            parts = []
            while True:
                if not self._accept_word("PARTITION"):
                    raise ParseError("expected PARTITION", self.cur)
                pname = self.ident()
                self.expect_kw("VALUES")
                if not (self._accept_word("LESS")
                        and self._accept_word("THAN")):
                    raise ParseError("expected LESS THAN", self.cur)
                if self._accept_word("MAXVALUE"):
                    bound = None
                else:
                    self.expect_op("(")
                    if self._accept_word("MAXVALUE"):
                        bound = None
                    else:
                        neg = self.accept_op("-")
                        bound = self._int_lit()
                        if neg:
                            bound = -bound
                    self.expect_op(")")
                parts.append((pname, bound))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            bounds = [b for _, b in parts if b is not None]
            if bounds != sorted(bounds) or (
                    None in [b for _, b in parts[:-1]]):
                raise ParseError("RANGE partition bounds must ascend "
                                 "(MAXVALUE last)", self.cur)
            return A.PartitionSpec("range", col, parts)
        if self._accept_word("HASH"):
            self.expect_op("(")
            col = self.ident()
            self.expect_op(")")
            if not self._accept_word("PARTITIONS"):
                raise ParseError("expected PARTITIONS", self.cur)
            n = self._int_lit()
            if not 1 <= n <= 1024:
                raise ParseError("PARTITIONS must be 1..1024", self.cur)
            return A.PartitionSpec(
                "hash", col, [(f"p{i}", None) for i in range(n)], n)
        raise ParseError("expected RANGE or HASH partitioning", self.cur)

    def _paren_name_list(self) -> list[str]:
        """Index column list; prefix lengths col(10) and ASC/DESC are
        accepted and ignored, as are trailing index options."""
        self.expect_op("(")
        out = []
        while True:
            out.append(self.ident())
            if self.accept_op("("):        # prefix length
                self._int_lit()
                self.expect_op(")")
            if not self.accept_kw("DESC"):
                self.accept_kw("ASC")
            if not self.accept_op(","):
                break
        self.expect_op(")")
        self._skip_index_options()
        return out

    def _skip_index_options(self):
        """USING BTREE|HASH, COMMENT '...', VISIBLE/INVISIBLE."""
        while True:
            if self.accept_kw("USING"):
                self.ident()
            elif self.accept_kw("COMMENT"):
                self.advance()             # string literal
            elif self.cur.kind == "ident" and self.cur.text.upper() in (
                    "VISIBLE", "INVISIBLE", "BTREE", "HASH"):
                self.advance()
            else:
                return

    def alter_stmt(self) -> A.Node:
        self.expect_kw("ALTER")
        if self.accept_kw("USER"):
            return A.AlterUser(self._user_password_list())
        if self.cur.kind == "ident" and self.cur.text.upper() == "RESOURCE":
            self.advance()
            self.expect_kw("GROUP")
            return self._resource_group_body(self.ident().lower(), False,
                                             True)
        self.expect_kw("TABLE")
        table = self.ident()
        dbq = None
        if self.accept_op("."):
            dbq, table = table, self.ident()
        at = A.AlterTable(table, db=dbq)
        while True:
            if self.accept_kw("ADD"):
                uniq = self.accept_kw("UNIQUE")
                if self.accept_kw("INDEX") or self.accept_kw("KEY") or uniq:
                    iname = self.ident() if self.cur.kind == "ident" else None
                    cols = self._paren_name_list()
                    at.actions.append(("add_index", iname, cols, uniq))
                else:
                    self.accept_kw("COLUMN")
                    at.actions.append(("add_column", self.column_def()))
            elif self.accept_kw("DROP"):
                if self.accept_kw("INDEX") or self.accept_kw("KEY"):
                    at.actions.append(("drop_index", self.ident()))
                else:
                    self.accept_kw("COLUMN")
                    at.actions.append(("drop_column", self.ident()))
            else:
                raise ParseError("unsupported ALTER TABLE action", self.cur)
            if not self.accept_op(","):
                break
        return at

    def _if_not_exists(self) -> bool:
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def _create_sequence(self) -> "A.CreateSequence":
        """CREATE SEQUENCE name [START [WITH] n] [INCREMENT [BY] n]
        [MINVALUE n | NOMINVALUE] [MAXVALUE n | NOMAXVALUE]
        [CACHE n | NOCACHE] [CYCLE | NOCYCLE]
        (reference: parser sequence options, ddl/sequence.go)."""
        ine = self._if_not_exists()
        cs = A.CreateSequence(self.ident(), if_not_exists=ine)

        def int_val() -> int:
            neg = self.accept_op("-")
            t = self.advance()
            if t.kind != "int":
                raise ParseError("expected integer sequence option", t)
            return -int(t.text) if neg else int(t.text)

        while self.cur.kind in ("kw", "ident"):
            w = self.cur.text.upper()
            if w == "START":
                self.advance()
                self._accept_word("WITH")
                cs.start = int_val()
            elif w == "INCREMENT":
                self.advance()
                self._accept_word("BY")
                cs.increment = int_val()
            elif w == "MINVALUE":
                self.advance()
                cs.min_value = int_val()
            elif w == "MAXVALUE":
                self.advance()
                cs.max_value = int_val()
            elif w in ("NOMINVALUE", "NOMAXVALUE", "NOCACHE", "NOCYCLE"):
                self.advance()
            elif w == "CACHE":
                self.advance()
                cs.cache = max(int_val(), 1)
            elif w == "CYCLE":
                self.advance()
                cs.cycle = True
            else:
                break
        return cs

    def column_def(self) -> A.ColumnDef:
        name = self.ident()
        tname, prec, scale = self.type_name()
        cd = A.ColumnDef(name, tname, prec, scale,
                         members=self._type_members)
        while True:
            if self.accept_kw("NOT"):
                self.expect_kw("NULL")
                cd.not_null = True
            elif self.accept_kw("NULL"):
                pass
            elif self.at_kw("PRIMARY"):
                self.advance()
                self.expect_kw("KEY")
                cd.primary_key = True
                cd.not_null = True
            elif self.accept_kw("UNIQUE"):
                self.accept_kw("KEY")
            elif self.accept_kw("DEFAULT"):
                cd.default = self.expr()
            elif self.accept_kw("AUTO_INCREMENT"):
                cd.auto_increment = True
            elif (self.at_kw("AS")
                  or (self.cur.kind in ("kw", "ident")
                      and self.cur.text.upper() == "GENERATED")):
                # [GENERATED ALWAYS] AS (expr) [VIRTUAL|STORED]
                if not self.at_kw("AS"):
                    self.advance()           # GENERATED
                    self._accept_word("ALWAYS")
                self.expect_kw("AS")
                self.expect_op("(")
                cd.generated = self.expr()
                self.expect_op(")")
                if self._accept_word("STORED"):
                    cd.generated_stored = True
                else:
                    self._accept_word("VIRTUAL")
            elif self.accept_kw("COMMENT"):
                self.advance()  # string
            elif self.at_kw("CHARACTER"):
                self.advance()
                self.expect_kw("SET")
                self.ident()
            elif self.accept_kw("COLLATE"):
                cd.collation = self.ident().lower()
            elif (self.cur.kind in ("kw", "ident")
                  and self.cur.text.upper() == "REFERENCES"):
                self.advance()
                fk = self._references_clause(None, cd.name, inline=True)
                cd.references = (fk.ref_table, fk.ref_column, fk.on_delete)
            else:
                break
        return cd

    def _references_clause(self, fname, column,
                           inline: bool = False) -> "A.ForeignKeyDef":
        """[REFERENCES already consumed when inline] parent (col)
        [ON DELETE RESTRICT|CASCADE|NO ACTION] [ON UPDATE RESTRICT|...]"""
        if not inline and not self._accept_word("REFERENCES"):
            raise ParseError("expected REFERENCES", self.cur)
        parent = self.ident()
        cols = self._paren_name_list()
        if len(cols) != 1:
            raise ParseError("only single-column REFERENCES supported",
                             self.cur)
        on_delete = "restrict"
        while self.at_kw("ON"):
            self.advance()
            if self.accept_kw("DELETE"):
                act = self.advance().text.upper()
                if act == "NO":
                    self._accept_word("ACTION")
                    act = "RESTRICT"
                if act not in ("RESTRICT", "CASCADE"):
                    raise ParseError(
                        f"unsupported ON DELETE {act}", self.cur)
                on_delete = act.lower()
            elif self.accept_kw("UPDATE"):
                act = self.advance().text.upper()
                if act == "NO":
                    self._accept_word("ACTION")
                    act = "RESTRICT"
                # only RESTRICT is enforced at update time; reject anything
                # else instead of silently downgrading CASCADE/SET NULL
                if act != "RESTRICT":
                    raise ParseError(
                        f"unsupported ON UPDATE {act}", self.cur)
            else:
                raise ParseError("expected DELETE or UPDATE after ON",
                                 self.cur)
        return A.ForeignKeyDef(fname, column, parent, cols[0], on_delete)

    def type_name(self) -> tuple[str, int, int]:
        t = self.cur
        if t.kind not in ("ident", "kw"):
            raise ParseError("expected type name", t)
        self.advance()
        name = t.text.upper()
        prec = scale = -1
        self._type_members = ()
        if name in ("ENUM", "SET"):
            self.expect_op("(")
            vals = [self._str_lit()]
            while self.accept_op(","):
                vals.append(self._str_lit())
            self.expect_op(")")
            self._type_members = tuple(vals)
        elif self.accept_op("("):
            prec = self._int_lit()
            if self.accept_op(","):
                scale = self._int_lit()
            self.expect_op(")")
        # UNSIGNED / ZEROFILL modifiers
        while self.cur.kind == "ident" and self.cur.text.upper() in (
                "UNSIGNED", "ZEROFILL", "SIGNED"):
            name += " " + self.advance().text.upper()
        return name, prec, scale

    # ---------------- DML ---------------- #

    def drop_stmt(self) -> A.Node:
        self.expect_kw("DROP")
        if self.at_kw("GLOBAL", "SESSION", "BINDING"):
            scope = "session"       # TiDB default scope is SESSION
            if self.at_kw("GLOBAL", "SESSION"):
                scope = self.advance().text.lower()
            self.expect_kw("BINDING")
            self.expect_kw("FOR")
            return A.DropBinding(scope, self._stmt_text_until(None))
        if self.cur.kind == "ident" and self.cur.text.upper() == "RESOURCE":
            self.advance()
            self.expect_kw("GROUP")
            ie = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                ie = True
            return A.DropResourceGroup(self.ident().lower(), ie)
        if self.accept_kw("USER"):
            ie = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                ie = True
            users = [self._user_spec()]
            while self.accept_op(","):
                users.append(self._user_spec())
            return A.DropUser(users, ie)
        if self.accept_kw("DATABASE"):
            ie = self.accept_kw("IF") and self.expect_kw("EXISTS") is not None
            return A.DropDatabase(self.ident(), ie)
        if self._accept_word("SEQUENCE"):
            ie = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                ie = True
            return A.DropSequence(self.ident(), ie)
        if self.accept_kw("INDEX"):
            ie = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                ie = True
            name = self.ident()
            self.expect_kw("ON")
            table = self.ident()
            dbq = None
            if self.accept_op("."):
                dbq, table = table, self.ident()
            return A.DropIndex(name, table, dbq, ie)
        if self.cur.kind == "ident" and self.cur.text.upper() == "VIEW":
            self.advance()
            ie = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                ie = True
            names = [self.ident()]
            while self.accept_op(","):
                names.append(self.ident())
            return A.DropView(names, ie)
        temporary = self._accept_word("TEMPORARY")
        self.expect_kw("TABLE")
        ie = False
        if self.accept_kw("IF"):
            self.expect_kw("EXISTS")
            ie = True

        def qname():
            # (db | None, name) tuple: a dotted string would mis-split
            # backtick identifiers that CONTAIN dots (`a.b`)
            n = self.ident()
            if self.accept_op("."):
                return (n, self.ident())
            return (None, n)

        names = [qname()]
        while self.accept_op(","):
            names.append(qname())
        return A.DropTable(names, ie, temporary)

    def insert_stmt(self, replace: bool = False) -> A.Insert:
        ignore = False
        if replace:
            self.expect_kw("REPLACE")
        else:
            self.expect_kw("INSERT")
            ignore = self.accept_kw("IGNORE")
        self.expect_kw("INTO")
        name = self.ident()
        dbq = None
        if self.accept_op("."):
            dbq, name = name, self.ident()
        ins = A.Insert(name, db=dbq, replace=replace, ignore=ignore)
        if self.accept_op("("):
            ins.columns = [self.ident()]
            while self.accept_op(","):
                ins.columns.append(self.ident())
            self.expect_op(")")
        if self.at_kw("SELECT", "WITH"):
            ins.select = self.select_query()
            self._maybe_on_dup(ins)
            return ins
        if self.at_kw("SET"):
            # INSERT ... SET col = expr, ... (single-row sugar)
            self.advance()
            while True:
                ins.columns.append(self.ident())
                self.expect_op("=")
                (ins.rows or ins.rows.append([]) or ins.rows)  # ensure row
                ins.rows[0].append(self.expr())
                if not self.accept_op(","):
                    break
            self._maybe_on_dup(ins)
            return ins
        self.expect_kw("VALUES")
        while True:
            self.expect_op("(")
            row = [self.expr()]
            while self.accept_op(","):
                row.append(self.expr())
            self.expect_op(")")
            ins.rows.append(row)
            if not self.accept_op(","):
                break
        self._maybe_on_dup(ins)
        return ins

    def _maybe_on_dup(self, ins: "A.Insert") -> None:
        """ON DUPLICATE KEY UPDATE col = expr, ... (upsert clause)."""
        if not self.at_kw("ON"):
            return
        self.advance()
        if not self._accept_word("DUPLICATE"):
            raise ParseError("expected DUPLICATE after ON", self.cur)
        self.expect_kw("KEY")
        self.expect_kw("UPDATE")
        while True:
            col = self.ident()
            self.expect_op("=")
            ins.on_dup.append((col, self.expr()))
            if not self.accept_op(","):
                break

    def _resource_group_body(self, name: str, ine: bool,
                             replace: bool) -> A.CreateResourceGroup:
        """RU_PER_SEC = N [BURSTABLE] [QUERY_LIMIT = (EXEC_ELAPSED = '1s'
        [,] ACTION = KILL|COOLDOWN)] (resource-group option grammar)."""
        rg = A.CreateResourceGroup(name, if_not_exists=ine, replace=replace)
        while True:
            if self.cur.kind != "ident":
                break
            opt = self.cur.text.upper()
            if opt == "RU_PER_SEC":
                self.advance()
                self.expect_op("=")
                rg.ru_per_sec = self._int_lit()
            elif opt == "BURSTABLE":
                self.advance()
                rg.burstable = True
            elif opt == "PRIORITY":
                self.advance()
                self.expect_op("=")
                tok = self.cur
                pr = self.advance().text.lower()
                if pr not in ("low", "medium", "high"):
                    raise ParseError("PRIORITY must be LOW|MEDIUM|HIGH",
                                     tok)
                rg.priority = pr
            elif opt == "QUERY_LIMIT":
                self.advance()
                self.expect_op("=")
                self.expect_op("(")
                while not self.at_op(")"):
                    if self.cur.kind == "eof":
                        raise ParseError("unterminated QUERY_LIMIT",
                                         self.cur)
                    sub = self.cur.text.upper()
                    self.advance()
                    self.expect_op("=")
                    if sub == "EXEC_ELAPSED":
                        tok = self.cur
                        txt = self._str_lit().strip().lower()
                        mult = 1.0
                        for suf, m in (("ms", 1e-3), ("s", 1.0),
                                       ("m", 60.0), ("h", 3600.0)):
                            if txt.endswith(suf):
                                txt = txt[:-len(suf)]
                                mult = m
                                break
                        try:
                            rg.exec_elapsed_sec = float(txt) * mult
                        except ValueError:
                            raise ParseError(
                                "bad EXEC_ELAPSED duration", tok)
                    elif sub == "ACTION":
                        tok = self.cur
                        act = self.advance().text.lower()
                        if act == "switch_group":
                            # SWITCH_GROUP(<name>): runaway statements
                            # re-price against the target group
                            self.expect_op("(")
                            rg.switch_target = self.ident().lower()
                            self.expect_op(")")
                        elif act not in ("kill", "cooldown"):
                            raise ParseError(
                                "ACTION must be KILL, COOLDOWN or "
                                "SWITCH_GROUP(<group>)", tok)
                        rg.action = act
                    else:
                        raise ParseError(f"unknown QUERY_LIMIT option "
                                         f"{sub}", self.cur)
                    self.accept_op(",")
                self.expect_op(")")
            else:
                break
        return rg

    def load_data_stmt(self) -> A.LoadData:
        self.expect_kw("LOAD")
        self.expect_kw("DATA")
        self.accept_kw("LOCAL")
        self.expect_kw("INFILE")
        ld = A.LoadData(path=self._str_lit())
        if self.accept_kw("REPLACE"):
            ld.replace = True
        elif self.accept_kw("IGNORE"):
            ld.ignore = True              # without it, dup keys ERROR
        self.expect_kw("INTO")
        self.expect_kw("TABLE")
        ld.table = self.ident()
        if self.accept_kw("FIELDS") or self.accept_kw("COLUMNS"):
            while True:
                if self.accept_kw("TERMINATED"):
                    self.expect_kw("BY")
                    ld.field_sep = self._str_lit()
                elif self.accept_kw("ENCLOSED"):
                    self.expect_kw("BY")
                    ld.enclosed = self._str_lit()
                elif self.accept_kw("OPTIONALLY"):
                    self.expect_kw("ENCLOSED")
                    self.expect_kw("BY")
                    ld.enclosed = self._str_lit()
                else:
                    break
        if self.accept_kw("LINES"):
            self.expect_kw("TERMINATED")
            self.expect_kw("BY")
            ld.line_sep = self._str_lit()
        if self.accept_kw("IGNORE"):
            ld.ignore_lines = self._int_lit()
            self.expect_kw("LINES")
        if self.accept_op("("):
            ld.columns = [self.ident()]
            while self.accept_op(","):
                ld.columns.append(self.ident())
            self.expect_op(")")
        return ld

    def update_stmt(self) -> A.Update:
        self.expect_kw("UPDATE")
        name = self.ident()
        dbq = None
        if self.accept_op("."):
            dbq, name = name, self.ident()
        self.expect_kw("SET")
        u = A.Update(name, db=dbq)
        while True:
            col = self.ident()
            self.expect_op("=")
            u.assignments.append((col, self.expr()))
            if not self.accept_op(","):
                break
        if self.accept_kw("WHERE"):
            u.where = self.expr()
        u.order_by, u.limit = self._dml_order_limit()
        return u

    def delete_stmt(self) -> A.Delete:
        self.expect_kw("DELETE")
        self.expect_kw("FROM")
        name = self.ident()
        dbq = None
        if self.accept_op("."):
            dbq, name = name, self.ident()
        d = A.Delete(name, db=dbq)
        if self.accept_kw("WHERE"):
            d.where = self.expr()
        d.order_by, d.limit = self._dml_order_limit()
        return d

    def _dml_order_limit(self):
        """[ORDER BY ...] [LIMIT n] tail of single-table UPDATE/DELETE."""
        order = []
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                e = self.expr()
                desc = bool(self.accept_kw("DESC")) \
                    or (self.accept_kw("ASC") and False)
                order.append((e, desc))
                if not self.accept_op(","):
                    break
        limit = None
        if self.accept_kw("LIMIT"):
            limit = self._int_lit()
        return order, limit

    def _show_like(self, st: "A.ShowStmt") -> "A.ShowStmt":
        if self.accept_kw("LIKE"):
            st.like = self._str_lit()
        return st

    def show_stmt(self) -> A.ShowStmt:
        self.expect_kw("SHOW")
        if self.accept_kw("CREATE"):
            self.expect_kw("TABLE")
            return A.ShowStmt("create table", self.ident())
        if self.accept_kw("BINDINGS"):
            return A.ShowStmt("bindings")       # target None = both scopes
        if self.at_kw("GLOBAL", "SESSION") \
                and self.toks[self.i + 1].kind == "kw" \
                and self.toks[self.i + 1].text == "BINDINGS":
            scope = self.advance().text.lower()
            self.advance()
            return A.ShowStmt("bindings", scope)
        if self.accept_kw("TABLES"):
            return A.ShowStmt("tables")
        if self.accept_kw("DATABASES"):
            return A.ShowStmt("databases")
        if self.accept_kw("COLUMNS"):
            self.expect_kw("FROM")
            return A.ShowStmt("columns", self.ident())
        if self.accept_kw("VARIABLES"):
            return self._show_like(A.ShowStmt("variables"))
        if self._accept_word("STATUS"):
            return self._show_like(A.ShowStmt("status"))
        if self.accept_kw("GLOBAL", "SESSION"):
            if self._accept_word("STATUS"):
                return self._show_like(A.ShowStmt("status"))
            self.expect_kw("VARIABLES")
            return self._show_like(A.ShowStmt("variables"))
        if self.accept_kw("INDEX", "KEYS"):
            self.expect_kw("FROM")
            return A.ShowStmt("index", self.ident())
        if self.accept_kw("GRANTS"):
            if self.accept_kw("FOR"):
                spec = self._user_spec()
                return A.ShowStmt("grants", f"{spec.user}@{spec.host}")
            return A.ShowStmt("grants")
        if self.accept_kw("COLLATION") or self._accept_word("COLLATION"):
            return self._show_like(A.ShowStmt("collation"))
        if self._accept_word("CHARACTER") or self._accept_word("CHARSET"):
            self._accept_word("SET")
            return self._show_like(A.ShowStmt("charset"))
        if self.cur.kind == "ident" and self.cur.text.upper() in (
                "STATS_META", "STATS_HISTOGRAMS", "STATS_TOPN",
                "STATEMENTS_SUMMARY", "SLOW_QUERIES", "PROCESSLIST"):
            kind = self.cur.text.lower()
            self.advance()
            return A.ShowStmt(kind)
        raise ParseError("unsupported SHOW", self.cur)

    def set_stmt(self) -> A.Node:
        self.expect_kw("SET")
        if self.cur.kind == "ident" and self.cur.text.upper() == "RESOURCE":
            self.advance()
            self.expect_kw("GROUP")
            return A.SetResourceGroup(self.ident().lower())
        if self._accept_word("NAMES"):
            # SET NAMES <charset> [COLLATE <collation>] -> the three
            # connection charset vars (MySQL handshake compat)
            cs = (self._str_lit() if self.cur.kind == "str"
                  else self.ident())
            coll = None
            if self.accept_kw("COLLATE") or self._accept_word("COLLATE"):
                coll = (self._str_lit() if self.cur.kind == "str"
                        else self.ident())
            st = A.SetStmt("session")
            for v in ("character_set_client", "character_set_results",
                      "character_set_connection"):
                st.assignments.append((v, A.Lit(cs, "str")))
            if coll:
                st.assignments.append(
                    ("collation_connection", A.Lit(coll, "str")))
            return st
        scope = "session"
        if self.accept_kw("GLOBAL"):
            scope = "global"
        elif self.accept_kw("SESSION"):
            scope = "session"
        if self._accept_word("TRANSACTION"):
            # SET [SESSION|GLOBAL] TRANSACTION ISOLATION LEVEL ... |
            # READ ONLY|WRITE -> transaction_* sysvars
            st = A.SetStmt(scope)
            while True:
                if self._accept_word("ISOLATION"):
                    self._accept_word("LEVEL")
                    parts = [self.ident().upper()]
                    if parts[0] in ("READ", "REPEATABLE"):
                        parts.append(self.ident().upper())
                    level = "-".join(parts)
                    st.assignments.append(
                        ("transaction_isolation", A.Lit(level, "str")))
                elif self._accept_word("READ"):
                    ro = 1 if self._accept_word("ONLY") else (
                        self._accept_word("WRITE") and 0)
                    st.assignments.append(
                        ("transaction_read_only", A.Lit(int(ro), "int")))
                else:
                    raise ParseError(
                        "expected ISOLATION LEVEL or READ", self.cur)
                if not self.accept_op(","):
                    return st
        st = A.SetStmt(scope)
        while True:
            user_var = False
            if self.accept_op("@"):
                if self.accept_op("@"):    # @@[scope.]sysvar
                    if self.cur.kind == "kw":
                        self.advance()
                        self.expect_op(".")
                else:                      # @uservar
                    user_var = True
            name = self.ident()
            if not self.accept_op("=") and not self.accept_op(":="):
                raise ParseError("expected =", self.cur)
            # MySQL boolean sysvar forms: ON/OFF are keywords, not exprs
            if self.at_kw("ON"):
                self.advance()
                val = A.Lit(1, "int")
            elif (self.cur.kind == "ident"
                  and self.cur.text.upper() == "OFF"):
                self.advance()
                val = A.Lit(0, "int")
            else:
                val = self.expr()
            (st.user_vars if user_var else st.assignments).append((name, val))
            if not self.accept_op(","):
                break
        return st

    # ---------------- expressions (precedence climbing) ---------------- #

    def expr(self) -> A.Node:
        return self.or_expr()

    def or_expr(self) -> A.Node:
        left = self.xor_expr()
        while self.at_kw("OR") or self.at_op("||"):
            self.advance()
            left = A.Binary("OR", left, self.xor_expr())
        return left

    def xor_expr(self) -> A.Node:
        left = self.and_expr()
        while self.accept_kw("XOR"):
            left = A.Binary("XOR", left, self.and_expr())
        return left

    def and_expr(self) -> A.Node:
        left = self.not_expr()
        while self.at_kw("AND") or self.at_op("&&"):
            self.advance()
            left = A.Binary("AND", left, self.not_expr())
        return left

    def not_expr(self) -> A.Node:
        if self.accept_kw("NOT"):
            return A.Unary("NOT", self.not_expr())
        return self.predicate()

    def predicate(self) -> A.Node:
        left = self.bit_or()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">=", "<=>"):
                op = self.advance().text
                if op == "!=":
                    op = "<>"
                right = self.bit_or()
                left = A.Binary(op, left, right)
                continue
            negated = False
            save = self.i
            if self.accept_kw("NOT"):
                negated = True
            if self.accept_kw("IN"):
                self.expect_op("(")
                if self.at_kw("SELECT", "WITH"):
                    sub = self.select_query()
                    self.expect_op(")")
                    left = A.InExpr(left, [A.SubqueryExpr(sub)], negated)
                else:
                    items = [self.expr()]
                    while self.accept_op(","):
                        items.append(self.expr())
                    self.expect_op(")")
                    left = A.InExpr(left, items, negated)
                continue
            if self.accept_kw("BETWEEN"):
                low = self.bit_or()
                self.expect_kw("AND")
                high = self.bit_or()
                left = A.BetweenExpr(left, low, high, negated)
                continue
            if self.accept_kw("LIKE"):
                left = A.LikeExpr(left, self.bit_or(), negated)
                continue
            if self._accept_word("REGEXP") or self._accept_word("RLIKE"):
                node = A.FuncCall("REGEXP_LIKE", [left, self.bit_or()])
                left = A.Unary("NOT", node) if negated else node
                continue
            if negated:
                self.i = save
                break
            if self.accept_kw("IS"):
                neg = self.accept_kw("NOT")
                if self.accept_kw("NULL"):
                    left = A.IsNullExpr(left, neg)
                elif self.accept_kw("TRUE"):
                    e = A.Binary("<>", left, A.Lit(0, "int"))
                    left = A.Unary("NOT", e) if neg else e
                elif self.accept_kw("FALSE"):
                    e = A.Binary("=", left, A.Lit(0, "int"))
                    left = A.Unary("NOT", e) if neg else e
                else:
                    raise ParseError("expected NULL/TRUE/FALSE after IS", self.cur)
                continue
            break
        return left

    def bit_or(self) -> A.Node:
        left = self.bit_and()
        while self.at_op("|"):
            self.advance()
            left = A.Binary("|", left, self.bit_and())
        return left

    def bit_and(self) -> A.Node:
        left = self.shift()
        while self.at_op("&"):
            self.advance()
            left = A.Binary("&", left, self.shift())
        return left

    def shift(self) -> A.Node:
        left = self.additive()
        while self.at_op("<<", ">>"):
            op = self.advance().text
            left = A.Binary(op, left, self.additive())
        return left

    def additive(self) -> A.Node:
        left = self.multiplicative()
        while self.at_op("+", "-"):
            op = self.advance().text
            left = A.Binary(op, left, self.multiplicative())
        return left

    def multiplicative(self) -> A.Node:
        left = self.unary()
        while True:
            if self.at_op("*", "/", "%"):
                op = self.advance().text
                left = A.Binary(op, left, self.unary())
            elif self.at_kw("DIV"):
                self.advance()
                left = A.Binary("DIV", left, self.unary())
            elif self.at_kw("MOD"):
                self.advance()
                left = A.Binary("%", left, self.unary())
            else:
                break
        return left

    def unary(self) -> A.Node:
        if self.at_op("-"):
            self.advance()
            return A.Unary("-", self.unary())
        if self.at_op("+"):
            self.advance()
            return self.unary()
        if self.at_op("~"):
            self.advance()
            return A.Unary("~", self.unary())
        return self.primary()

    def primary(self) -> A.Node:
        t = self.cur
        if t.kind == "op" and t.text == "@":
            self.advance()
            if self.accept_op("@"):
                scope = ""
                if self.cur.kind in ("kw", "ident") and \
                        self.cur.text.upper() in ("GLOBAL", "SESSION"):
                    scope = self.advance().text.lower()
                    self.expect_op(".")
                return A.SysVar(self.ident().lower(), scope)
            return A.SysVar(self.ident().lower(), user=True)
        if (t.kind == "kw" and t.text in ("DATABASE", "SCHEMA")
                and self.toks[self.i + 1].kind == "op"
                and self.toks[self.i + 1].text == "("):
            name = t.text
            self.advance()
            self.expect_op("(")
            self.expect_op(")")
            return A.FuncCall(name, [])
        if (t.kind == "kw" and t.text == "INSERT"
                and self.toks[self.i + 1].kind == "op"
                and self.toks[self.i + 1].text == "("):
            # INSERT(str, pos, len, newstr) — the string function
            self.advance()
            self.expect_op("(")
            args = [self.expr()]
            while self.accept_op(","):
                args.append(self.expr())
            self.expect_op(")")
            return A.FuncCall("INSERT", args)
        if (t.kind == "kw" and t.text == "VALUES"
                and self.toks[self.i + 1].kind == "op"
                and self.toks[self.i + 1].text == "("):
            # VALUES(col) inside ON DUPLICATE KEY UPDATE assignments
            self.advance()
            self.expect_op("(")
            inner = self.expr()
            self.expect_op(")")
            return A.FuncCall("VALUES", [inner])
        if t.kind == "int":
            self.advance()
            return A.Lit(int(t.text), "int")
        if t.kind == "decimal":
            self.advance()
            return A.Lit(t.text, "decimal")
        if t.kind == "float":
            self.advance()
            return A.Lit(float(t.text), "float")
        if t.kind == "str":
            self.advance()
            return A.Lit(t.text, "str")
        if self.accept_kw("NULL"):
            return A.Lit(None, "null")
        if self.accept_kw("TRUE"):
            return A.Lit(1, "bool")
        if self.accept_kw("FALSE"):
            return A.Lit(0, "bool")
        if self.at_kw("DATE") and self.toks[self.i + 1].kind == "str":
            self.advance()
            return A.Lit(self.advance().text, "date")
        if self.at_kw("TIMESTAMP") and self.toks[self.i + 1].kind == "str":
            self.advance()
            return A.Lit(self.advance().text, "datetime")
        if self.accept_kw("INTERVAL"):
            val = self.expr()
            unit = self.advance().text.upper()
            return A.Lit(val, "interval", unit)
        if self.at_kw("CASE"):
            return self.case_expr()
        if self.at_kw("CAST", "CONVERT"):
            return self.cast_expr()
        if self.accept_kw("EXISTS"):
            self.expect_op("(")
            sub = self.select_query()
            self.expect_op(")")
            return A.ExistsExpr(sub)
        if self.accept_op("("):
            if self.at_kw("SELECT", "WITH"):
                sub = self.select_query()
                self.expect_op(")")
                return A.SubqueryExpr(sub)
            e = self.expr()
            self.expect_op(")")
            return e
        # function call or identifier
        if t.kind == "ident" or (t.kind == "kw" and t.text in _FUNC_KEYWORDS
                                 ) or (t.kind == "kw" and t.text in _NONRESERVED):
            name = self.advance().text
            if self.at_op("("):
                return self.func_call(name)
            parts = [name]
            while self.at_op(".") and self.toks[self.i + 1].kind in ("ident", "kw"):
                self.advance()
                parts.append(self.ident())
            return A.Ident(tuple(parts))
        raise ParseError("unexpected token in expression", t)

    def case_expr(self) -> A.CaseExpr:
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.expr()
        branches = []
        while self.accept_kw("WHEN"):
            c = self.expr()
            self.expect_kw("THEN")
            branches.append((c, self.expr()))
        else_ = None
        if self.accept_kw("ELSE"):
            else_ = self.expr()
        self.expect_kw("END")
        return A.CaseExpr(operand, branches, else_)

    def cast_expr(self) -> A.CastExpr:
        self.advance()  # CAST | CONVERT
        self.expect_op("(")
        arg = self.expr()
        if not self.accept_kw("AS"):
            self.expect_op(",")  # CONVERT(x, type)
        tname, prec, scale = self.type_name()
        self.expect_op(")")
        return A.CastExpr(arg, tname, prec, scale)

    def func_call(self, name: str) -> A.Node:
        self.expect_op("(")
        nm = name.upper()
        # SQL-standard special argument forms
        if nm in ("SUBSTRING", "SUBSTR", "MID"):
            first = self.expr()
            if self.accept_kw("FROM"):
                fc = A.FuncCall("SUBSTRING")
                fc.args = [first, self.expr()]
                if self.accept_kw("FOR"):
                    fc.args.append(self.expr())
                self.expect_op(")")
                return fc
            fc = A.FuncCall("SUBSTRING")
            fc.args = [first]
            while self.accept_op(","):
                fc.args.append(self.expr())
            self.expect_op(")")
            return fc
        if nm == "TRIM":
            mode = "BOTH"
            if self.cur.kind == "ident" and self.cur.text.upper() in (
                    "BOTH", "LEADING", "TRAILING"):
                mode = self.advance().text.upper()
                remstr = None
                if not self.at_kw("FROM"):
                    remstr = self.expr()
                self.expect_kw("FROM")
                target = self.expr()
            else:
                first = self.expr()
                if self.accept_kw("FROM"):
                    remstr, target = first, self.expr()
                else:
                    remstr, target = None, first
            self.expect_op(")")
            fc = A.FuncCall({"BOTH": "TRIM", "LEADING": "LTRIM",
                             "TRAILING": "RTRIM"}[mode])
            fc.args = [target] + ([remstr] if remstr is not None else [])
            return fc
        if nm == "EXTRACT":
            unit = self.advance().text.upper()
            self.expect_kw("FROM")
            fc = A.FuncCall("EXTRACT")
            fc.args = [A.Lit(unit, "str"), self.expr()]
            self.expect_op(")")
            return fc
        if nm == "POSITION":
            a = self.bit_or()   # stop below IN so `x IN y` doesn't swallow it
            self.expect_kw("IN")
            fc = A.FuncCall("POSITION")
            fc.args = [a, self.expr()]
            self.expect_op(")")
            return fc
        fc = A.FuncCall(nm)
        if self.at_op("*"):
            self.advance()
            self.expect_op(")")
            fc.args = [A.Star()]
        else:
            if self.accept_kw("DISTINCT"):
                fc.distinct = True
            if not self.at_op(")"):
                fc.args.append(self.expr())
                while self.accept_op(","):
                    fc.args.append(self.expr())
            self.expect_op(")")
        if self.accept_kw("OVER"):
            fc.over = self.window_spec()
        return fc

    def window_spec(self) -> A.WindowSpec:
        self.expect_op("(")
        ws = A.WindowSpec()
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            ws.partition_by.append(self.expr())
            while self.accept_op(","):
                ws.partition_by.append(self.expr())
        if self.at_kw("ORDER"):
            self.advance()
            self.expect_kw("BY")
            ws.order_by = self._order_by_list()
        if self.at_kw("ROWS", "RANGE"):
            unit = self.advance().text.lower()
            ws.frame = (unit,) + self._frame_bounds()
        self.expect_op(")")
        return ws

    def _frame_bounds(self) -> tuple:
        if self.accept_kw("BETWEEN"):
            lo = self._frame_bound()
            self.expect_kw("AND")
            hi = self._frame_bound()
        else:
            lo = self._frame_bound()
            hi = ("current", 0)
        return lo, hi

    def _frame_bound(self) -> tuple[str, int]:
        if self.accept_kw("UNBOUNDED"):
            if self.accept_kw("PRECEDING"):
                return ("unbounded_preceding", 0)
            self.expect_kw("FOLLOWING")
            return ("unbounded_following", 0)
        if self.accept_kw("CURRENT"):
            self.expect_kw("ROW")
            return ("current", 0)
        n = self._int_lit()
        if self.accept_kw("PRECEDING"):
            return ("preceding", n)
        self.expect_kw("FOLLOWING")
        return ("following", n)


# keywords that can also start function calls (YEAR(x), DATE(x), IF(...))
_FUNC_KEYWORDS = {"YEAR", "MONTH", "DAY", "HOUR", "MINUTE", "SECOND", "IF",
                  "DATE", "TIME", "SUBSTRING", "TRUNCATE", "LEFT", "RIGHT",
                  "MOD", "CHARACTER", "REPLACE"}

# keywords allowed as plain identifiers (column/table names)
_NONRESERVED = {"YEAR", "MONTH", "DAY", "HOUR", "MINUTE", "SECOND", "DATE",
                "TIME", "TIMESTAMP", "COMMENT", "ENGINE", "CHARSET",
                "DATABASES", "TABLES", "VARIABLES", "COLUMNS", "GLOBAL",
                "SESSION", "KEY", "DEFAULT", "ADMIN", "CHECK", "BEGIN",
                "TRANSACTION", "TRUNCATE", "ROW", "ROWS", "RANGE", "OVER",
                "PARTITION", "CURRENT", "WINDOW", "RECURSIVE", "PRECEDING",
                "FOLLOWING", "UNBOUNDED", "USER", "GRANTS", "PRIVILEGES",
                "PASSWORD", "FLUSH", "IDENTIFIED",
                "DATA", "LOCAL", "FIELDS", "LINES", "TERMINATED",
                "ENCLOSED", "OPTIONALLY", "INFILE"}


_HINT_RE = None


def _parse_hints(body: str) -> list[tuple]:
    """`NAME(arg, ...) NAME2(...) ...` -> [(NAME, [args])] (the
    parser_driver optimizer-hint grammar, simplified)."""
    import re
    global _HINT_RE
    if _HINT_RE is None:
        _HINT_RE = re.compile(
            r"([A-Za-z_][A-Za-z0-9_]*)\s*(?:\(([^)]*)\))?")
    out = []
    for m in _HINT_RE.finditer(body):
        args = [a.strip().strip("`") for a in (m.group(2) or "").split(",")
                if a.strip()]
        out.append((m.group(1).upper(), args))
    return out


def parse_sql(sql: str) -> list[A.Node]:
    return Parser(sql).parse()


def parse_one(sql: str) -> A.Node:
    stmts = parse_sql(sql)
    if len(stmts) != 1:
        raise ValueError(f"expected one statement, got {len(stmts)}")
    return stmts[0]


__all__ = ["Parser", "ParseError", "parse_sql", "parse_one"]
