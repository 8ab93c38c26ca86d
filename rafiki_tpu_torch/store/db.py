"""Database adapters: the MetaStore's SQL dialect seam.

The port's own copy of ``rafiki_tpu/store/db.py``: ``Cursor``,
``DatabaseAdapter``, ``SqliteAdapter``, ``qmark_to_format``,
``sqlite_ddl_to_postgres``, ``PostgresAdapter`` and ``adapter_for``. The
MetaStore writes one dialect of SQL (qmark ``?`` placeholders,
SQLite-flavoured DDL), and an adapter owns everything engine-specific:
connections, placeholder style, DDL translation, duplicate-column
detection for migrations, and rows as dicts.

``SqliteAdapter`` is the embedded default (a single-host control plane).
``PostgresAdapter`` carries the server-database deployment: it
translates placeholders and DDL and drives psycopg2, which it imports
only when it is built (neither this package nor its tests need the
driver); without psycopg2 it raises ``ImportError`` naming the install,
as JAX's does. New engines are one subclass each.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence


class Cursor:
    """Uniform cursor result: mapping rows + rowcount."""

    def __init__(self, rows: Optional[List[Dict[str, Any]]],
                 rowcount: int) -> None:
        self._rows = rows or []
        self.rowcount = rowcount

    def fetchone(self) -> Optional[Dict[str, Any]]:
        return self._rows[0] if self._rows else None

    def fetchall(self) -> List[Dict[str, Any]]:
        return list(self._rows)


class DatabaseAdapter:
    """Engine-specific half of the MetaStore. The MetaStore calls only
    these methods plus ``execute``; SQL it passes is qmark-style with
    SQLite-flavored DDL, which each adapter translates as needed."""

    def connect(self):  # pragma: no cover - interface
        raise NotImplementedError

    def execute(self, conn, sql: str, args: Sequence[Any] = (),
                max_rows: Optional[int] = None) -> Cursor:
        """Run one statement; ``max_rows`` bounds how many result rows
        are materialized (None = all)."""
        raise NotImplementedError

    def commit(self, conn) -> None:
        conn.commit()

    def rollback(self, conn) -> None:
        """Discard the open transaction after a FAILED statement —
        without it the error leaks into the next caller's commit (and on
        engines with strict transactions, poisons the connection)."""
        try:
            conn.rollback()
        except Exception:  # rafiki: noqa[silent-except] — a dead
            pass           # connection can't rollback; the next
            # execute reports it

    def close(self, conn) -> None:
        conn.close()

    def init_schema(self, conn, schema_sql: str) -> None:
        """Create tables (idempotent) + engine session setup."""
        raise NotImplementedError

    def try_migration(self, conn, ddl: str) -> bool:
        """Run an ``ALTER TABLE ... ADD COLUMN``; False when the column
        already exists (the no-op re-run), raise on anything else."""
        raise NotImplementedError

    def backup(self, conn, path: str) -> None:
        """Consistent online snapshot of the whole database to a file
        at ``path``. Engines without a one-file snapshot concept may
        raise NotImplementedError."""
        raise NotImplementedError(
            "online backup is not supported by this database engine")


# ---------------------------------------------------------------- sqlite

class SqliteAdapter(DatabaseAdapter):
    def __init__(self, path: str, read_only: bool = False) -> None:
        self.path = path
        #: open via the ro URI: auditors (doctor) must not be able to
        #: write — or migrate — a live stack's database, and sqlite
        #: refuses to CREATE a missing file in this mode
        self.read_only = read_only and path != ":memory:"

    def connect(self):
        import sqlite3

        if self.read_only:
            conn = sqlite3.connect(f"file:{self.path}?mode=ro",
                                   uri=True, check_same_thread=False)
            conn.execute("PRAGMA busy_timeout=10000")
        else:
            conn = sqlite3.connect(self.path, check_same_thread=False)
        conn.row_factory = sqlite3.Row
        return conn

    def execute(self, conn, sql: str, args: Sequence[Any] = (),
                max_rows: Optional[int] = None) -> Cursor:
        cur = conn.execute(sql, tuple(args))
        if cur.description is None:
            rows = None
        elif max_rows is not None:
            rows = [dict(r) for r in cur.fetchmany(max_rows)]
        else:
            rows = [dict(r) for r in cur.fetchall()]
        return Cursor(rows, cur.rowcount)

    def init_schema(self, conn, schema_sql: str) -> None:
        if self.path != ":memory:":
            conn.execute("PRAGMA journal_mode=WAL")
        # cross-process writers: wait instead of instant 'database is
        # locked' (the MetaStore lock only serializes one process)
        conn.execute("PRAGMA busy_timeout=10000")
        conn.execute("PRAGMA foreign_keys=ON")
        conn.executescript(schema_sql)

    def backup(self, conn, path: str) -> None:
        """SQLite online backup API: page-wise copy that is consistent
        under concurrent writers (WAL readers keep going). Falls back
        to ``VACUUM INTO`` (sqlite >= 3.27) when the driver lacks
        ``Connection.backup``. The destination is replaced atomically
        via a temp file so a crash mid-backup never leaves a torn
        snapshot at ``path``."""
        import os
        import sqlite3

        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            if hasattr(conn, "backup"):
                dest = sqlite3.connect(tmp)
                try:
                    conn.backup(dest)
                finally:
                    dest.close()
            else:  # pragma: no cover - ancient driver fallback
                conn.execute("VACUUM INTO ?", (tmp,))
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def try_migration(self, conn, ddl: str) -> bool:
        import sqlite3

        try:
            conn.execute(ddl)
            return True
        except sqlite3.OperationalError as e:
            if "duplicate column" in str(e).lower():
                return False  # already migrated — the no-op re-run
            raise  # locked DB / real DDL failure must not be silent:
            # running without the column breaks every later write


# -------------------------------------------------------------- postgres

def qmark_to_format(sql: str) -> str:
    """``?`` placeholders → ``%s`` (psycopg2 paramstyle), leaving quoted
    literals untouched."""
    out: List[str] = []
    in_str = False
    for ch in sql:
        if ch == "'":
            in_str = not in_str
            out.append(ch)
        elif ch == "?" and not in_str:
            out.append("%s")
        else:
            out.append(ch)
    return "".join(out)


def sqlite_ddl_to_postgres(schema_sql: str) -> str:
    """SQLite-flavored DDL → PostgreSQL: AUTOINCREMENT ids become
    BIGSERIAL, BLOB becomes BYTEA, REAL becomes DOUBLE PRECISION."""
    sql = re.sub(r"INTEGER PRIMARY KEY AUTOINCREMENT",
                 "BIGSERIAL PRIMARY KEY", schema_sql)
    sql = re.sub(r"\bBLOB\b", "BYTEA", sql)
    sql = re.sub(r"\bREAL\b", "DOUBLE PRECISION", sql)
    return sql


# backup() is intentionally unimplemented: Postgres has no one-file
# snapshot, and the DatabaseAdapter contract says such engines raise
# NotImplementedError (callers feature-test via try/except)
class PostgresAdapter(DatabaseAdapter):  # rafiki: noqa[hub-verb-parity]
    """MetaStore on a PostgreSQL server (multi-host control planes).

    Translation is pure string work (unit-tested without a server); the
    driver is psycopg2, imported lazily so the sqlite-only image never
    needs it."""

    def __init__(self, url: str) -> None:
        try:
            import psycopg2  # noqa: F401
            import psycopg2.extras  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "PostgresAdapter needs psycopg2 (pip install "
                "psycopg2-binary); this image ships sqlite-only — use a "
                "path/sqlite:// url, or install the driver on the "
                "control-plane host") from e
        self.url = url

    def connect(self):
        import psycopg2
        import psycopg2.extras

        conn = psycopg2.connect(
            self.url, cursor_factory=psycopg2.extras.RealDictCursor)
        # autocommit: every MetaStore write is a single fenced statement
        # (atomic on its own), reads must not pin an idle-in-transaction
        # snapshot, and a failed statement must not abort a shared
        # transaction that poisons every later call on this connection
        conn.autocommit = True
        return conn

    def execute(self, conn, sql: str, args: Sequence[Any] = (),
                max_rows: Optional[int] = None) -> Cursor:
        with conn.cursor() as cur:
            cur.execute(qmark_to_format(sql), tuple(args))
            if cur.description is None:
                rows = None
            elif max_rows is not None:
                rows = [dict(r) for r in cur.fetchmany(max_rows)]
            else:
                rows = [dict(r) for r in cur.fetchall()]
            return Cursor(rows, cur.rowcount)

    def commit(self, conn) -> None:
        pass  # autocommit — see connect()

    def rollback(self, conn) -> None:
        pass  # autocommit: failed statements leave no open transaction

    def init_schema(self, conn, schema_sql: str) -> None:
        with conn.cursor() as cur:
            cur.execute(sqlite_ddl_to_postgres(schema_sql))

    def try_migration(self, conn, ddl: str) -> bool:
        import psycopg2

        try:
            with conn.cursor() as cur:
                cur.execute(sqlite_ddl_to_postgres(ddl))
            return True
        except psycopg2.errors.DuplicateColumn:
            return False


def adapter_for(url_or_path: str,
                read_only: bool = False) -> DatabaseAdapter:
    """``:memory:`` / a filesystem path / ``sqlite:///path`` → SQLite;
    ``postgresql://...`` (or ``postgres://``) → PostgreSQL.
    ``read_only`` is sqlite-only (the doctor/backup CLIs audit a local
    stack's file) — asking for it on another engine is a caller bug."""
    u = str(url_or_path)
    if u.startswith(("postgresql://", "postgres://")):
        if read_only:
            raise ValueError(
                "read_only MetaStore access is only supported on the "
                "sqlite backend")
        return PostgresAdapter(u)
    if u.startswith("sqlite:///"):
        return SqliteAdapter(u[len("sqlite:///"):] or ":memory:",
                             read_only=read_only)
    return SqliteAdapter(u, read_only=read_only)
