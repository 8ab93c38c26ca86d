"""MetaStore: the system's metadata on SQLite — the trial surface.

The port's own copy of ``rafiki_tpu/store/meta_store.py``: the whole
``_SCHEMA`` (so a database file the port creates is one the JAX admin
opens, and the reverse), the connection setup and trial-column
migrations of ``MetaStore.__init__`` with the SQLite half of
``store/db.py`` (``SqliteAdapter``: WAL, ``busy_timeout``, sqlite rows as
dicts), and the methods a train worker and its deploy step call:
``create_train_job``, ``create_sub_train_job``, ``create_trial``,
``get_trial``, ``update_trial``,
``mark_trial_completed`` / ``mark_trial_errored`` (fenced on RUNNING),
``heartbeat_trial``, ``claim_trial_for_resume``,
``get_trials_of_sub_train_job``, ``get_best_trials_of_train_job``,
``add_trial_log`` and
``get_trial_logs``. Users, models, datasets, inference jobs, services,
respawn budgets, the admin lease and backups stay with the JAX admin.
Only SQLite is ported: a ``postgresql://`` url raises, naming the backend.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS users (
    id TEXT PRIMARY KEY, email TEXT UNIQUE NOT NULL,
    password_hash TEXT NOT NULL, salt TEXT NOT NULL,
    user_type TEXT NOT NULL, banned INTEGER DEFAULT 0,
    created_at REAL NOT NULL);
CREATE TABLE IF NOT EXISTS models (
    id TEXT PRIMARY KEY, user_id TEXT NOT NULL, name TEXT NOT NULL,
    task TEXT NOT NULL, model_class TEXT NOT NULL,
    model_bytes BLOB NOT NULL, checkpoint_id TEXT,
    dependencies TEXT, access_right TEXT NOT NULL DEFAULT 'PRIVATE',
    docker_image TEXT, created_at REAL NOT NULL,
    UNIQUE(user_id, name));
CREATE TABLE IF NOT EXISTS datasets (
    id TEXT PRIMARY KEY, user_id TEXT NOT NULL, name TEXT NOT NULL,
    task TEXT NOT NULL, uri TEXT NOT NULL, size_bytes INTEGER,
    stat TEXT, created_at REAL NOT NULL);
CREATE TABLE IF NOT EXISTS train_jobs (
    id TEXT PRIMARY KEY, user_id TEXT NOT NULL, app TEXT NOT NULL,
    app_version INTEGER NOT NULL, task TEXT NOT NULL,
    budget TEXT NOT NULL, train_dataset_id TEXT NOT NULL,
    val_dataset_id TEXT NOT NULL, train_args TEXT,
    status TEXT NOT NULL, created_at REAL NOT NULL,
    stopped_at REAL, UNIQUE(user_id, app, app_version));
CREATE TABLE IF NOT EXISTS sub_train_jobs (
    id TEXT PRIMARY KEY, train_job_id TEXT NOT NULL,
    model_id TEXT NOT NULL, status TEXT NOT NULL,
    advisor_service_id TEXT, created_at REAL NOT NULL);
CREATE TABLE IF NOT EXISTS trials (
    id TEXT PRIMARY KEY, sub_train_job_id TEXT NOT NULL,
    trial_no INTEGER NOT NULL, model_id TEXT NOT NULL,
    worker_id TEXT, knobs TEXT, score REAL, budget_scale REAL DEFAULT 1.0,
    shape_signature TEXT, status TEXT NOT NULL,
    params_saved INTEGER DEFAULT 0, error TEXT, error_class TEXT,
    heartbeat_at REAL,
    started_at REAL, stopped_at REAL, created_at REAL NOT NULL);
CREATE INDEX IF NOT EXISTS idx_trials_job ON trials(sub_train_job_id);
CREATE TABLE IF NOT EXISTS trial_logs (
    id INTEGER PRIMARY KEY AUTOINCREMENT, trial_id TEXT NOT NULL,
    time REAL NOT NULL, kind TEXT NOT NULL, data TEXT NOT NULL);
CREATE INDEX IF NOT EXISTS idx_trial_logs ON trial_logs(trial_id);
CREATE TABLE IF NOT EXISTS inference_jobs (
    id TEXT PRIMARY KEY, user_id TEXT NOT NULL,
    train_job_id TEXT NOT NULL, budget TEXT, status TEXT NOT NULL,
    predictor_host TEXT, created_at REAL NOT NULL, stopped_at REAL);
CREATE TABLE IF NOT EXISTS services (
    id TEXT PRIMARY KEY, service_type TEXT NOT NULL,
    status TEXT NOT NULL, train_job_id TEXT, sub_train_job_id TEXT,
    inference_job_id TEXT, host TEXT, port INTEGER, pid INTEGER,
    devices TEXT, error TEXT, created_at REAL NOT NULL, stopped_at REAL,
    spawn_spec TEXT, start_time REAL DEFAULT 0);
CREATE TABLE IF NOT EXISTS respawn_budgets (
    lineage TEXT PRIMARY KEY, count INTEGER NOT NULL DEFAULT 0,
    updated_at REAL NOT NULL);
CREATE TABLE IF NOT EXISTS admin_lease (
    id INTEGER PRIMARY KEY CHECK (id = 1), holder TEXT NOT NULL,
    generation INTEGER NOT NULL, heartbeat_at REAL NOT NULL,
    acquired_at REAL NOT NULL, ttl_s REAL NOT NULL DEFAULT 15);
"""


def _now() -> float:
    return time.time()


def _uid() -> str:
    return uuid.uuid4().hex


class MetaStore:
    """Thread-safe trial metadata over one SQLite connection with a
    process-wide lock. ``db_path``: a file path, ``:memory:`` or a
    ``sqlite:///path`` url."""

    def __init__(self, db_path: str = ":memory:") -> None:
        path = str(db_path)
        if path.startswith(("postgresql://", "postgres://")):
            raise NotImplementedError(
                "the PostgreSQL MetaStore backend is not ported yet; use a "
                "sqlite path")
        if path.startswith("sqlite:///"):
            path = path[len("sqlite:///"):] or ":memory:"
        self._db_path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()
        with self._lock:
            if path != ":memory:":
                self._conn.execute("PRAGMA journal_mode=WAL")
            # cross-process writers wait instead of failing on the lock
            self._conn.execute("PRAGMA busy_timeout=10000")
            self._conn.execute("PRAGMA foreign_keys=ON")
            self._conn.executescript(_SCHEMA)
            # pre-heartbeat databases (no-op once the columns exist)
            self._try_migration(
                "ALTER TABLE trials ADD COLUMN heartbeat_at REAL")
            if self._try_migration(
                    "ALTER TABLE trials ADD COLUMN error_class TEXT"):
                # under the old semantics every ERRORED row was resumable
                self._exec(
                    "UPDATE trials SET error_class='preemption' "
                    "WHERE status='ERRORED' AND error_class IS NULL")
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # ---- low-level helpers ----
    def _try_migration(self, ddl: str) -> bool:
        try:
            self._conn.execute(ddl)
            return True
        except sqlite3.OperationalError as e:
            if "duplicate column" in str(e).lower():
                return False
            raise

    def _exec(self, sql: str, args: tuple = ()) -> sqlite3.Cursor:
        """Execute one statement (the caller holds the lock); a failed
        statement rolls back so its error cannot leak into the next
        caller's commit."""
        try:
            return self._conn.execute(sql, args)
        except Exception:
            self._conn.rollback()
            raise

    def _insert(self, table: str, row: Dict[str, Any]) -> None:
        cols = ", ".join(row)
        ph = ", ".join("?" for _ in row)
        with self._lock:
            self._exec(f"INSERT INTO {table} ({cols}) VALUES ({ph})",
                       tuple(row.values()))
            self._conn.commit()

    def _update(self, table: str, row_id: str,
                fields: Dict[str, Any]) -> None:
        sets = ", ".join(f"{k}=?" for k in fields)
        with self._lock:
            cur = self._exec(f"UPDATE {table} SET {sets} WHERE id=?",
                             (*fields.values(), row_id))
            if cur.rowcount == 0:
                self._conn.rollback()
                raise KeyError(f"no {table} row {row_id!r}")
            self._conn.commit()

    #: columns stored as JSON text, decoded on every read
    _JSON_COLS = ("knobs", "budget", "train_args", "config", "spawn_spec")

    def _decode(self, row: Dict[str, Any]) -> Dict[str, Any]:
        for col in self._JSON_COLS:
            v = row.get(col)
            if isinstance(v, str):
                try:
                    row[col] = json.loads(v)
                except ValueError:
                    pass
        return row

    def _one(self, sql: str, args: tuple = ()) -> Optional[Dict[str, Any]]:
        with self._lock:
            row = self._exec(sql, args).fetchone()
        return self._decode(dict(row)) if row else None

    def _all(self, sql: str, args: tuple = ()) -> List[Dict[str, Any]]:
        with self._lock:
            rows = self._exec(sql, args).fetchall()
        return [self._decode(dict(r)) for r in rows]

    # ---- train jobs ----
    def create_train_job(self, user_id: str, app: str, app_version: int,
                         task: str, budget: Dict[str, Any],
                         train_dataset_id: str, val_dataset_id: str,
                         train_args: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
        row = {"id": _uid(), "user_id": user_id, "app": app,
               "app_version": app_version, "task": task,
               "budget": json.dumps(budget),
               "train_dataset_id": train_dataset_id,
               "val_dataset_id": val_dataset_id,
               "train_args": json.dumps(train_args or {}),
               "status": "STARTED", "created_at": _now()}
        self._insert("train_jobs", row)
        return self._one("SELECT * FROM train_jobs WHERE id=?",
                         (row["id"],))  # type: ignore[return-value]

    # ---- sub train jobs ----
    def create_sub_train_job(self, train_job_id: str,
                             model_id: str) -> Dict[str, Any]:
        row = {"id": _uid(), "train_job_id": train_job_id,
               "model_id": model_id, "status": "STARTED",
               "created_at": _now()}
        self._insert("sub_train_jobs", row)
        return self._one("SELECT * FROM sub_train_jobs WHERE id=?",
                         (row["id"],))  # type: ignore[return-value]

    # ---- trials ----
    def create_trial(self, sub_train_job_id: str, trial_no: int,
                     model_id: str, knobs: Dict[str, Any],
                     worker_id: str = "", budget_scale: float = 1.0,
                     shape_sig: str = "") -> Dict[str, Any]:
        row = {"id": _uid(), "sub_train_job_id": sub_train_job_id,
               "trial_no": trial_no, "model_id": model_id,
               "worker_id": worker_id, "knobs": json.dumps(knobs),
               "budget_scale": budget_scale, "shape_signature": shape_sig,
               "status": "RUNNING", "started_at": _now(),
               "created_at": _now()}
        self._insert("trials", row)
        return self.get_trial(row["id"])  # type: ignore[return-value]

    def get_trial(self, trial_id: str) -> Optional[Dict[str, Any]]:
        return self._one("SELECT * FROM trials WHERE id=?", (trial_id,))

    def update_trial(self, trial_id: str, **fields: Any) -> None:
        if "knobs" in fields and not isinstance(fields["knobs"], str):
            fields["knobs"] = json.dumps(fields["knobs"])
        self._update("trials", trial_id, fields)

    def mark_trial_completed(self, trial_id: str, score: float,
                             params_saved: bool) -> bool:
        """Fenced terminal update: only a still-RUNNING row completes.
        Returns False when a resume claimant already TERMINATED the row
        (this worker was presumed dead, e.g. a long VM suspend) — the
        caller must then NOT feed the score back to the advisor, or one
        trial_no gets double feedback."""
        with self._lock:
            cur = self._exec(
                "UPDATE trials SET status='COMPLETED', score=?, "
                "params_saved=?, stopped_at=? WHERE id=? "
                "AND status='RUNNING'",
                (score, int(params_saved), _now(), trial_id))
            self._conn.commit()
            return cur.rowcount == 1

    def mark_trial_errored(self, trial_id: str, error: str,
                           error_class: str = "deterministic") -> bool:
        """Fenced like :meth:`mark_trial_completed`.

        ``error_class`` records WHY the trial died, which decides whether
        peers may resume it: ``"preemption"`` (infra fault — device loss,
        OOM-kill, connection reset; worth re-running elsewhere) vs
        ``"deterministic"`` (code/knob bug recorded by a live worker —
        re-running it anywhere yields the same crash, so resume is
        forbidden and only the advisor's trial_errored accounting runs).
        """
        with self._lock:
            cur = self._exec(
                "UPDATE trials SET status='ERRORED', error=?, "
                "error_class=?, stopped_at=? "
                "WHERE id=? AND status='RUNNING'",
                (error[:4000], error_class, _now(), trial_id))
            self._conn.commit()
            return cur.rowcount == 1

    def heartbeat_trial(self, trial_id: str) -> None:
        """Liveness beacon: the owning worker stamps this every few
        seconds while training, so peers can tell a preempted trial from
        one that is merely slow."""
        self.update_trial(trial_id, heartbeat_at=_now())

    def claim_trial_for_resume(self, trial_id: str, worker_id: str,
                               stale_after_s: float = 60.0) -> bool:
        """Atomically take ownership of an orphaned trial for resume.

        Eligible: status ERRORED with ``error_class='preemption'`` (an
        infra fault a live worker managed to record — device loss, OOM —
        worth re-running on healthy hardware), or RUNNING with no
        heartbeat for ``stale_after_s`` — a live peer heartbeats every
        few seconds, so a fresh heartbeat means the trial is NOT orphaned
        and the claim loses. Deterministic ERRORED rows (code/knob bugs)
        are NEVER claimable: re-running them anywhere reproduces the
        crash, and N workers would otherwise re-run one bad trial up to
        N*max_resumes times (ADVICE r3). The staleness condition sits
        inside the UPDATE itself, so exactly one concurrent claimant can
        win and a revived heartbeat between scan and claim voids the
        claim. The original error text is preserved (pointer appended).
        """
        cutoff = _now() - stale_after_s
        marker = f"resumed by {worker_id}"
        with self._lock:
            cur = self._exec(
                "UPDATE trials SET status='TERMINATED', stopped_at=?, "
                "error=(CASE WHEN error IS NULL OR error='' THEN ? "
                "ELSE error || ? END) "
                "WHERE id=? AND ((status='ERRORED' AND "
                "error_class='preemption') OR (status='RUNNING' "
                "AND COALESCE(heartbeat_at, started_at, 0) < ?))",
                (_now(), marker, f" | {marker}", trial_id, cutoff))
            self._conn.commit()
            return cur.rowcount == 1

    def get_trials_of_sub_train_job(
            self, sub_train_job_id: str) -> List[Dict[str, Any]]:
        return self._all(
            "SELECT * FROM trials WHERE sub_train_job_id=? ORDER BY trial_no",
            (sub_train_job_id,))

    def get_best_trials_of_train_job(self, train_job_id: str,
                                     max_count: int = 2
                                     ) -> List[Dict[str, Any]]:
        """Top completed full-budget trials with saved params — the set the
        inference job deploys (reference default: top 2)."""
        return self._all(
            "SELECT t.* FROM trials t JOIN sub_train_jobs s "
            "ON t.sub_train_job_id = s.id "
            "WHERE s.train_job_id=? AND t.status='COMPLETED' "
            "AND t.params_saved=1 AND t.budget_scale>=1.0 "
            "ORDER BY t.score DESC LIMIT ?", (train_job_id, max_count))

    # ---- trial logs ----
    def add_trial_log(self, trial_id: str, kind: str, data: Dict[str, Any],
                      t: Optional[float] = None) -> None:
        with self._lock:
            self._exec(
                "INSERT INTO trial_logs (trial_id, time, kind, data) "
                "VALUES (?,?,?,?)",
                (trial_id, t if t is not None else _now(), kind,
                 json.dumps(data)))
            self._conn.commit()

    def get_trial_logs(self, trial_id: str) -> List[Dict[str, Any]]:
        rows = self._all(
            "SELECT * FROM trial_logs WHERE trial_id=? ORDER BY id",
            (trial_id,))
        for r in rows:
            r["data"] = json.loads(r["data"])
        return rows
