"""Port parity: ``rafiki_tpu_torch/store/db.py``, the MetaStore's SQL
dialect seam, against ``rafiki_tpu/store/db.py``.

- ``qmark_to_format`` and ``sqlite_ddl_to_postgres`` give JAX's strings
  on the port ``MetaStore``'s own schema and statements and on seeded SQL
  strings (quoted literals holding ``?``, BLOB / REAL words inside other
  names).
- ``adapter_for`` picks the same engine for the same url, and refuses
  ``read_only`` off sqlite as JAX does; ``PostgresAdapter`` without
  psycopg2 raises JAX's ``ImportError``, also through
  ``MetaStore("postgresql://...")``.
- With a stand-in psycopg2 module (no server here), the port's
  ``PostgresAdapter`` sends the statements JAX's sends, and a port
  ``MetaStore`` runs its schema, a write and a read through it.
- No port module imports psycopg2 at load, and the sqlite file the port
  writes through the adapter is the one the JAX store reads.
"""

import ast
import random
import sys
import types
from pathlib import Path

import pytest

from rafiki_tpu.store import db as jdb
from rafiki_tpu.store.meta_store import MetaStore as JMetaStore
from rafiki_tpu_torch.store import db as pdb
from rafiki_tpu_torch.store import meta_store as pms
from rafiki_tpu_torch.store.meta_store import MetaStore

ROOT = Path(__file__).resolve().parent.parent


def _statements():
    """The port MetaStore's own SQL: its schema's statements and every
    literal SQL string in its source."""
    out = [s.strip() + ";" for s in pms._SCHEMA.split(";") if s.strip()]
    tree = ast.parse(Path(pms.__file__).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.lstrip().upper().startswith(
                    ("SELECT", "INSERT", "UPDATE", "DELETE", "ALTER",
                     "CREATE")):
            out.append(node.value)
    return out


def _seeded_sql(n, seed):
    rng = random.Random(seed)
    words = ["SELECT", "*", "FROM", "t", "WHERE", "a=?", "AND", "b=?",
             "'it''s ? here'", "'?'", "BLOB", "REAL", "BLOBS", "REALLY",
             "x_REAL", "INTEGER PRIMARY KEY AUTOINCREMENT", "(?,?,?)",
             "'a?b'", "?", "''", "name", "VALUES", "blob", "Real"]
    return [" ".join(rng.choice(words) for _ in range(rng.randrange(1, 14)))
            for _ in range(n)]


def test_translation_equals_jax_on_the_meta_store_schema():
    stmts = _statements()
    assert len(stmts) > 40
    for sql in stmts:
        assert pdb.qmark_to_format(sql) == jdb.qmark_to_format(sql)
        assert pdb.sqlite_ddl_to_postgres(sql) == \
            jdb.sqlite_ddl_to_postgres(sql)
    ddl = pdb.sqlite_ddl_to_postgres(pms._SCHEMA)
    assert "BIGSERIAL PRIMARY KEY" in ddl and "BYTEA" in ddl
    assert "DOUBLE PRECISION" in ddl and "AUTOINCREMENT" not in ddl


@pytest.mark.parametrize("seed", range(4))
def test_translation_equals_jax_on_seeded_sql(seed):
    for sql in _seeded_sql(200, seed):
        assert pdb.qmark_to_format(sql) == jdb.qmark_to_format(sql), sql
        assert pdb.sqlite_ddl_to_postgres(sql) == \
            jdb.sqlite_ddl_to_postgres(sql), sql
    assert pdb.qmark_to_format("a=? AND b='x?y' AND c=?") == \
        "a=%s AND b='x?y' AND c=%s"


@pytest.mark.parametrize("url,read_only", [
    (":memory:", False), ("/tmp/x.db", False), ("/tmp/x.db", True),
    ("sqlite:///", False), ("sqlite:////tmp/y.db", True),
    ("postgresql://h/db", True), ("postgres://h/db", True),
])
def test_adapter_for_picks_what_jax_picks(url, read_only):
    def run(mod):
        try:
            a = mod.adapter_for(url, read_only=read_only)
        except (ValueError, ImportError) as e:
            return type(e).__name__, str(e)
        return type(a).__name__, a.path, a.read_only

    assert run(pdb) == run(jdb)


@pytest.fixture()
def no_psycopg2(monkeypatch):
    """psycopg2 made unimportable, whether or not the host has it."""
    monkeypatch.setitem(sys.modules, "psycopg2", None)
    monkeypatch.setitem(sys.modules, "psycopg2.extras", None)


def test_postgres_without_psycopg2_raises_as_jax_does(no_psycopg2):
    msgs = []
    for mod in (pdb, jdb):
        with pytest.raises(ImportError) as ei:
            mod.PostgresAdapter("postgresql://localhost/rafiki")
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "psycopg2" in msgs[0]
    with pytest.raises(ImportError, match="psycopg2"):
        MetaStore("postgresql://localhost/rafiki")
    with pytest.raises(ImportError, match="psycopg2"):
        JMetaStore("postgresql://localhost/rafiki")


class _FakeCursor:
    def __init__(self, log, rows):
        self.log, self._rows, self.description, self.rowcount = log, rows, \
            None, 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def execute(self, sql, args=()):
        self.log.append((sql, tuple(args)))
        if sql.lstrip().upper().startswith("SELECT"):
            self.description = [("c",)]
            self.rowcount = len(self._rows)
        else:
            self.description, self.rowcount = None, 1

    def fetchmany(self, n):
        return self._rows[:n]

    def fetchall(self):
        return list(self._rows)


class _FakeConn:
    def __init__(self, log, rows):
        self.log, self.rows, self.autocommit = log, rows, False

    def cursor(self):
        return _FakeCursor(self.log, self.rows)

    def close(self):
        self.log.append(("close", ()))


@pytest.fixture()
def fake_psycopg2(monkeypatch):
    """A stand-in psycopg2: connections record every statement and
    answer SELECTs with the rows in ``state["rows"]``."""
    state = {"log": [], "rows": [], "urls": []}

    class DuplicateColumn(Exception):
        pass

    def connect(url, cursor_factory=None):
        state["urls"].append((url, cursor_factory))
        return _FakeConn(state["log"], state["rows"])

    mod = types.ModuleType("psycopg2")
    mod.connect = connect
    mod.extras = types.ModuleType("psycopg2.extras")
    mod.extras.RealDictCursor = "RealDictCursor"
    mod.errors = types.SimpleNamespace(DuplicateColumn=DuplicateColumn)
    monkeypatch.setitem(sys.modules, "psycopg2", mod)
    monkeypatch.setitem(sys.modules, "psycopg2.extras", mod.extras)
    return state


def test_postgres_adapter_sends_what_jax_sends(fake_psycopg2):
    logs = []
    for mod in (pdb, jdb):
        fake_psycopg2["log"].clear()
        fake_psycopg2["rows"][:] = [{"id": "a", "n": 1},
                                    {"id": "b", "n": 2}]
        a = mod.adapter_for("postgresql://u@h/db")
        conn = a.connect()
        assert conn.autocommit
        a.init_schema(conn, pms._SCHEMA)
        assert a.try_migration(conn, "ALTER TABLE trials ADD COLUMN "
                                     "x REAL")
        one = a.execute(conn, "SELECT * FROM t WHERE id=? AND s='?'",
                        ("a",), max_rows=1)
        every = a.execute(conn, "SELECT * FROM t")
        upd = a.execute(conn, "UPDATE t SET n=? WHERE id=?", (3, "a"))
        a.commit(conn)
        a.rollback(conn)
        with pytest.raises(NotImplementedError):
            a.backup(conn, "/tmp/never.db")
        a.close(conn)
        logs.append((list(fake_psycopg2["log"]), one.fetchall(),
                     every.fetchall(), upd.rowcount, upd.fetchone()))
    assert logs[0] == logs[1]
    sent = logs[0][0]
    assert sent[2] == ("SELECT * FROM t WHERE id=%s AND s='?'", ("a",))
    assert fake_psycopg2["urls"][0] == ("postgresql://u@h/db",
                                        "RealDictCursor")


def test_meta_store_runs_on_the_postgres_adapter(fake_psycopg2):
    """The port MetaStore's schema, a write and a read go through the
    adapter as ``%s`` statements (the stand-in answers SELECTs with one
    row)."""
    store = MetaStore("postgresql://u@h/db")
    log = fake_psycopg2["log"]
    assert "BIGSERIAL PRIMARY KEY" in log[0][0]
    assert store._db_path == "postgresql://u@h/db"
    fake_psycopg2["rows"][:] = [{"id": "j1", "budget": '{"A": 1}',
                                 "status": "RUNNING"}]
    store.update_inference_job("j1", status="STOPPED")
    assert log[-1] == ("UPDATE inference_jobs SET status=%s WHERE id=%s",
                       ("STOPPED", "j1"))
    job = store.get_inference_job("j1")
    assert job["budget"] == {"A": 1}
    assert log[-1] == ("SELECT * FROM inference_jobs WHERE id=%s",
                       ("j1",))
    with pytest.raises(NotImplementedError):
        store.backup("/tmp/never.db")


def test_no_port_module_imports_a_database_driver_at_load():
    drivers = ("psycopg2", "psycopg", "pg8000", "asyncpg")
    bad = []
    for f in sorted((ROOT / "rafiki_tpu_torch").rglob("*.py")):
        tree = ast.parse(f.read_text())
        for node in tree.body:  # module level only
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [(f.name, n) for n in names
                    if n.split(".")[0] in drivers]
    assert not bad, bad
    assert "psycopg2" not in sys.modules or sys.modules["psycopg2"] is None \
        or not hasattr(sys.modules["psycopg2"], "__file__")


def test_the_sqlite_file_is_the_one_jax_reads(tmp_path):
    """Through the adapter the port writes the same sqlite file as
    before: WAL mode, the JAX schema table for table, rows the JAX store
    reads, and a backup JAX opens."""
    import sqlite3

    path = tmp_path / "m.db"
    port = MetaStore(str(path))
    user = port.create_user("a@b", "pw", "ADMIN")
    job = port.create_train_job(user["id"], "app", 1, "IMAGE_CLASSIFICATION",
                                {"TRIAL_COUNT": 2}, "d1", "d2")
    lease = port.acquire_admin_lease("holder", ttl_s=5.0)
    assert lease["generation"] == 1
    assert port.acquire_admin_lease("other", ttl_s=5.0) is None
    conn = sqlite3.connect(str(path))
    assert conn.execute("PRAGMA journal_mode").fetchone()[0] == "wal"
    conn.close()
    jax_store = JMetaStore(str(path))
    assert jax_store.get_train_job(job["id"])["budget"] == {"TRIAL_COUNT": 2}
    assert jax_store.authenticate_user("a@b", "pw")["id"] == user["id"]
    out = port.backup(str(tmp_path / "b.db"))
    assert out["bytes"] > 0
    assert JMetaStore(out["path"]).get_train_job(job["id"])["app"] == "app"
    ro = MetaStore(str(path), read_only=True)
    assert ro.get_train_job(job["id"])["status"] == job["status"]
