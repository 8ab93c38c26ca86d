"""MetaStore: the system's metadata on SQLite.

The port's own copy of ``rafiki_tpu/store/meta_store.py``: the whole
``_SCHEMA`` (so a database file the port creates is one the JAX admin
opens, and the reverse), the connection setup and trial-column
migrations of ``MetaStore.__init__`` with the SQLite half of
``store/db.py`` (``SqliteAdapter``: WAL, ``busy_timeout``, sqlite rows as
dicts), and every method the train worker, the admin and the services
manager call: users and authentication (``create_user``,
``authenticate_user``, ...), models, datasets, train and sub-train
jobs, trials (``mark_trial_completed`` / ``mark_trial_errored`` fenced on
RUNNING, ``claim_trial_for_resume``, ``get_best_trials_of_train_job``,
trial logs), inference jobs, services, the respawn budgets, the admin
lease, the read-only open of the auditors (``read_only=True``) and the
online ``backup``. Every statement goes through ``store/db.py``'s
adapter, as in JAX: SQLite for a path, ``:memory:`` or ``sqlite:///``
url (the file format unchanged), ``PostgresAdapter`` for a
``postgresql://`` url (it raises without psycopg2, as JAX's does).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
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
    ``sqlite:///path`` url. ``read_only`` opens a file through sqlite's
    ``mode=ro`` uri and runs no DDL: the auditors (``doctor --workdir``,
    the backup command) cannot write or migrate a live stack's store."""

    def __init__(self, db_path: str = ":memory:",
                 read_only: bool = False) -> None:
        from rafiki_tpu_torch.store.db import adapter_for

        self._adapter = adapter_for(str(db_path), read_only=read_only)
        #: the sqlite file (what the train workers are told to open), or
        #: the server url
        self._db_path = getattr(self._adapter, "path", str(db_path))
        self._read_only = read_only and self._db_path != ":memory:"
        self._conn = self._adapter.connect()
        self._lock = threading.RLock()
        if self._read_only:
            return
        with self._lock:
            self._adapter.init_schema(self._conn, _SCHEMA)
            # pre-heartbeat databases (no-op once the columns exist)
            self._adapter.try_migration(
                self._conn, "ALTER TABLE trials ADD COLUMN heartbeat_at "
                            "REAL")
            if self._adapter.try_migration(
                    self._conn,
                    "ALTER TABLE trials ADD COLUMN error_class TEXT"):
                # under the old semantics every ERRORED row was resumable
                self._exec(
                    "UPDATE trials SET error_class='preemption' "
                    "WHERE status='ERRORED' AND error_class IS NULL")
            self._adapter.commit(self._conn)

    def close(self) -> None:
        with self._lock:
            self._adapter.close(self._conn)

    # ---- low-level helpers ----
    def _exec(self, sql: str, args: tuple = (), max_rows=None):
        """Execute one statement through the adapter (the caller holds
        the lock) and return its mapping-row cursor; a failed statement
        rolls back so its error cannot leak into the next caller's
        commit."""
        try:
            return self._adapter.execute(self._conn, sql, args,
                                         max_rows=max_rows)
        except Exception:
            self._adapter.rollback(self._conn)
            raise

    def _insert(self, table: str, row: Dict[str, Any]) -> None:
        cols = ", ".join(row)
        ph = ", ".join("?" for _ in row)
        with self._lock:
            self._exec(f"INSERT INTO {table} ({cols}) VALUES ({ph})",
                       tuple(row.values()))
            self._adapter.commit(self._conn)

    def _update(self, table: str, row_id: str,
                fields: Dict[str, Any]) -> None:
        sets = ", ".join(f"{k}=?" for k in fields)
        with self._lock:
            cur = self._exec(f"UPDATE {table} SET {sets} WHERE id=?",
                             (*fields.values(), row_id))
            if cur.rowcount == 0:
                self._adapter.rollback(self._conn)
                raise KeyError(f"no {table} row {row_id!r}")
            self._adapter.commit(self._conn)

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
            row = self._exec(sql, args, max_rows=1).fetchone()
        return self._decode(dict(row)) if row else None

    def _all(self, sql: str, args: tuple = ()) -> List[Dict[str, Any]]:
        with self._lock:
            rows = self._exec(sql, args).fetchall()
        return [self._decode(dict(r)) for r in rows]

    # ---- users ----
    def create_user(self, email: str, password: str,
                    user_type: str) -> Dict[str, Any]:
        salt = os.urandom(16).hex()
        row = {"id": _uid(), "email": email,
               "password_hash": _hash_password(password, salt), "salt": salt,
               "user_type": user_type, "created_at": _now()}
        self._insert("users", row)
        return self.get_user(row["id"])  # type: ignore[return-value]

    def get_user(self, user_id: str) -> Optional[Dict[str, Any]]:
        return self._one("SELECT * FROM users WHERE id=?", (user_id,))

    def get_user_by_email(self, email: str) -> Optional[Dict[str, Any]]:
        return self._one("SELECT * FROM users WHERE email=?", (email,))

    def authenticate_user(self, email: str,
                          password: str) -> Optional[Dict[str, Any]]:
        user = self.get_user_by_email(email)
        if user is None or user["banned"]:
            return None
        expected = _hash_password(password, user["salt"])
        if not hmac.compare_digest(expected, user["password_hash"]):
            return None
        return user

    def ban_user(self, user_id: str) -> None:
        self._update("users", user_id, {"banned": 1})

    # ---- models ----
    def create_model(self, user_id: str, name: str, task: str,
                     model_class: str, model_bytes: bytes,
                     dependencies: Optional[Dict[str, str]] = None,
                     access_right: str = "PRIVATE") -> Dict[str, Any]:
        row = {"id": _uid(), "user_id": user_id, "name": name, "task": task,
               "model_class": model_class, "model_bytes": model_bytes,
               "dependencies": json.dumps(dependencies or {}),
               "access_right": access_right, "created_at": _now()}
        self._insert("models", row)
        return self.get_model(row["id"])  # type: ignore[return-value]

    def get_model(self, model_id: str) -> Optional[Dict[str, Any]]:
        return self._one("SELECT * FROM models WHERE id=?", (model_id,))

    def get_model_by_name(self, user_id: str,
                          name: str) -> Optional[Dict[str, Any]]:
        return self._one(
            "SELECT * FROM models WHERE user_id=? AND name=?",
            (user_id, name))

    def get_available_models(self, task: Optional[str] = None,
                             user_id: Optional[str] = None
                             ) -> List[Dict[str, Any]]:
        """Models usable by ``user_id``: their own plus PUBLIC ones."""
        sql = "SELECT * FROM models WHERE 1=1"
        args: list = []
        if task is not None:
            sql += " AND task=?"
            args.append(task)
        if user_id is not None:
            sql += " AND (user_id=? OR access_right='PUBLIC')"
            args.append(user_id)
        return self._all(sql + " ORDER BY created_at", tuple(args))

    # ---- datasets ----
    def create_dataset(self, user_id: str, name: str, task: str, uri: str,
                       size_bytes: int = 0,
                       stat: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
        row = {"id": _uid(), "user_id": user_id, "name": name, "task": task,
               "uri": uri, "size_bytes": size_bytes,
               "stat": json.dumps(stat or {}), "created_at": _now()}
        self._insert("datasets", row)
        return self.get_dataset(row["id"])  # type: ignore[return-value]

    def get_dataset(self, dataset_id: str) -> Optional[Dict[str, Any]]:
        return self._one("SELECT * FROM datasets WHERE id=?", (dataset_id,))

    def get_datasets(self, user_id: str,
                     task: Optional[str] = None) -> List[Dict[str, Any]]:
        if task:
            return self._all(
                "SELECT * FROM datasets WHERE user_id=? AND task=?",
                (user_id, task))
        return self._all("SELECT * FROM datasets WHERE user_id=?", (user_id,))

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
        return self.get_train_job(row["id"])  # type: ignore[return-value]

    def get_train_job(self, job_id: str) -> Optional[Dict[str, Any]]:
        return self._one("SELECT * FROM train_jobs WHERE id=?", (job_id,))

    def get_train_jobs_of_user(self,
                               user_id: str) -> List[Dict[str, Any]]:
        return self._all(
            "SELECT * FROM train_jobs WHERE user_id=? "
            "ORDER BY created_at DESC", (user_id,))

    def get_train_jobs_of_app(self, user_id: str,
                              app: str) -> List[Dict[str, Any]]:
        return self._all(
            "SELECT * FROM train_jobs WHERE user_id=? AND app=? "
            "ORDER BY app_version DESC", (user_id, app))

    def get_latest_train_job_of_app(self, user_id: str,
                                    app: str) -> Optional[Dict[str, Any]]:
        jobs = self.get_train_jobs_of_app(user_id, app)
        return jobs[0] if jobs else None

    def update_train_job(self, job_id: str, **fields: Any) -> None:
        self._update("train_jobs", job_id, fields)

    # ---- sub train jobs ----
    def create_sub_train_job(self, train_job_id: str,
                             model_id: str) -> Dict[str, Any]:
        row = {"id": _uid(), "train_job_id": train_job_id,
               "model_id": model_id, "status": "STARTED",
               "created_at": _now()}
        self._insert("sub_train_jobs", row)
        return self.get_sub_train_job(row["id"])  # type: ignore[return-value]

    def get_sub_train_job(self, sid: str) -> Optional[Dict[str, Any]]:
        return self._one("SELECT * FROM sub_train_jobs WHERE id=?", (sid,))

    def get_sub_train_jobs_of_train_job(
            self, train_job_id: str) -> List[Dict[str, Any]]:
        return self._all(
            "SELECT * FROM sub_train_jobs WHERE train_job_id=?",
            (train_job_id,))

    def update_sub_train_job(self, sid: str, **fields: Any) -> None:
        self._update("sub_train_jobs", sid, fields)

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
            self._adapter.commit(self._conn)
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
            self._adapter.commit(self._conn)
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
            self._adapter.commit(self._conn)
            return cur.rowcount == 1

    def get_trials_of_sub_train_job(
            self, sub_train_job_id: str) -> List[Dict[str, Any]]:
        return self._all(
            "SELECT * FROM trials WHERE sub_train_job_id=? ORDER BY trial_no",
            (sub_train_job_id,))

    def get_trials_of_train_job(self,
                                train_job_id: str) -> List[Dict[str, Any]]:
        return self._all(
            "SELECT t.* FROM trials t JOIN sub_train_jobs s "
            "ON t.sub_train_job_id = s.id WHERE s.train_job_id=? "
            "ORDER BY t.trial_no", (train_job_id,))

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
            self._adapter.commit(self._conn)

    def get_trial_logs(self, trial_id: str) -> List[Dict[str, Any]]:
        rows = self._all(
            "SELECT * FROM trial_logs WHERE trial_id=? ORDER BY id",
            (trial_id,))
        for r in rows:
            r["data"] = json.loads(r["data"])
        return rows

    # ---- inference jobs ----
    def create_inference_job(self, user_id: str, train_job_id: str,
                             budget: Optional[Dict[str, Any]] = None
                             ) -> Dict[str, Any]:
        row = {"id": _uid(), "user_id": user_id,
               "train_job_id": train_job_id,
               "budget": json.dumps(budget or {}), "status": "STARTED",
               "created_at": _now()}
        self._insert("inference_jobs", row)
        return self.get_inference_job(row["id"])  # type: ignore[return-value]

    def get_inference_job(self, job_id: str) -> Optional[Dict[str, Any]]:
        return self._one("SELECT * FROM inference_jobs WHERE id=?", (job_id,))

    def get_inference_jobs_of_train_job(
            self, train_job_id: str) -> List[Dict[str, Any]]:
        return self._all(
            "SELECT * FROM inference_jobs WHERE train_job_id=? "
            "ORDER BY created_at DESC", (train_job_id,))

    def get_inference_jobs(self, user_id: Optional[str] = None
                           ) -> List[Dict[str, Any]]:
        if user_id:
            return self._all(
                "SELECT * FROM inference_jobs WHERE user_id=? "
                "ORDER BY created_at DESC", (user_id,))
        return self._all(
            "SELECT * FROM inference_jobs ORDER BY created_at DESC")

    def update_inference_job(self, job_id: str, **fields: Any) -> None:
        self._update("inference_jobs", job_id, fields)

    # ---- services ----
    def create_service(self, service_type: str,
                       train_job_id: Optional[str] = None,
                       sub_train_job_id: Optional[str] = None,
                       inference_job_id: Optional[str] = None,
                       host: str = "", port: int = 0, pid: int = 0,
                       devices: Optional[List[int]] = None,
                       spawn_spec: Optional[Dict[str, Any]] = None,
                       start_time: float = 0.0) -> Dict[str, Any]:
        """``spawn_spec`` (the module/config/slot recipe) and
        ``start_time`` (the pid's kernel start time) are recorded as the
        JAX admin records them."""
        row = {"id": _uid(), "service_type": service_type,
               "status": "STARTED", "train_job_id": train_job_id,
               "sub_train_job_id": sub_train_job_id,
               "inference_job_id": inference_job_id, "host": host,
               "port": port, "pid": pid,
               "devices": json.dumps(devices or []),
               "spawn_spec": json.dumps(spawn_spec)
               if spawn_spec is not None else None,
               "start_time": start_time, "created_at": _now()}
        self._insert("services", row)
        return self.get_service(row["id"])  # type: ignore[return-value]

    def get_service(self, service_id: str) -> Optional[Dict[str, Any]]:
        return self._one("SELECT * FROM services WHERE id=?", (service_id,))

    def get_services(self, status: Optional[str] = None
                     ) -> List[Dict[str, Any]]:
        if status:
            return self._all("SELECT * FROM services WHERE status=?",
                             (status,))
        return self._all("SELECT * FROM services")

    def update_service(self, service_id: str, **fields: Any) -> None:
        if "spawn_spec" in fields and \
                not isinstance(fields["spawn_spec"], (str, type(None))):
            fields["spawn_spec"] = json.dumps(fields["spawn_spec"])
        self._update("services", service_id, fields)

    # ---- respawn budgets ----
    @staticmethod
    def _lineage(service_type: str, job_id: str) -> str:
        return f"{service_type}:{job_id}"

    def incr_respawn_count(self, service_type: str, job_id: str) -> int:
        """Atomically bump and return the (service type, job) lineage's
        respawn count; durable across admin restarts."""
        lineage = self._lineage(service_type, job_id)
        with self._lock:
            cur = self._exec(
                "UPDATE respawn_budgets SET count=count+1, updated_at=? "
                "WHERE lineage=?", (_now(), lineage))
            if cur.rowcount == 0:
                self._exec(
                    "INSERT INTO respawn_budgets (lineage, count, "
                    "updated_at) VALUES (?,?,?)", (lineage, 1, _now()))
            self._adapter.commit(self._conn)
            row = self._exec(
                "SELECT count FROM respawn_budgets WHERE lineage=?",
                (lineage,)).fetchone()
        return int(row["count"]) if row else 1

    def get_respawn_counts(self) -> Dict[str, int]:
        """All lineages → count (lineage = ``"<type>:<job_id>"``)."""
        return {r["lineage"]: int(r["count"]) for r in self._all(
            "SELECT lineage, count FROM respawn_budgets")}

    # ---- admin lease (single-writer fencing) ----
    def acquire_admin_lease(self, holder: str,
                            ttl_s: float = 15.0
                            ) -> Optional[Dict[str, Any]]:
        """Claim the single-writer admin lease (one row, id=1, whose
        ``generation`` only grows): insert at generation 1 when there is
        none; renew when ``holder`` already holds it; take it over at
        generation + 1 (``took_over``) when the holder's heartbeat is
        older than the TTL it was granted with; ``None`` when a live
        other holds it. Cross-process atomicity comes from the
        database: the fresh insert races on the primary key, takeovers
        are conditional on the observed holder and generation."""
        now = _now()
        with self._lock:
            row = self._exec("SELECT * FROM admin_lease WHERE id=1",
                             max_rows=1).fetchone()
            if row is None:
                try:
                    self._exec(
                        "INSERT INTO admin_lease (id, holder, "
                        "generation, heartbeat_at, acquired_at, ttl_s) "
                        "VALUES (1,?,?,?,?,?)",
                        (holder, 1, now, now, ttl_s))
                    self._adapter.commit(self._conn)
                except Exception:
                    # two fresh boots raced the primary key from separate
                    # processes: a row now means the other won and this
                    # one is fenced; anything else is a real error
                    self._adapter.rollback(self._conn)
                    if self._exec("SELECT 1 FROM admin_lease WHERE "
                                  "id=1", max_rows=1).fetchone() is None:
                        raise
                    return None
                return {"holder": holder, "generation": 1,
                        "took_over": False}
            if row["holder"] == holder:
                self._exec(
                    "UPDATE admin_lease SET heartbeat_at=?, ttl_s=? "
                    "WHERE id=1 AND holder=?", (now, ttl_s, holder))
                self._adapter.commit(self._conn)
                return {"holder": holder,
                        "generation": int(row["generation"]),
                        "took_over": False}
            held_ttl = float(row["ttl_s"] or 0) or ttl_s
            if now - float(row["heartbeat_at"] or 0) <= held_ttl:
                return None  # live other admin: fenced out
            gen = int(row["generation"]) + 1
            cur = self._exec(
                "UPDATE admin_lease SET holder=?, generation=?, "
                "heartbeat_at=?, acquired_at=?, ttl_s=? WHERE id=1 "
                "AND holder=? AND generation=?",
                (holder, gen, now, now, ttl_s, row["holder"],
                 row["generation"]))
            self._adapter.commit(self._conn)
            if cur.rowcount == 0:
                return None  # raced another takeover: it won
            return {"holder": holder, "generation": gen,
                    "took_over": True}

    def renew_admin_lease(self, holder: str) -> bool:
        """Heartbeat the lease; False once a newer admin took over."""
        with self._lock:
            cur = self._exec(
                "UPDATE admin_lease SET heartbeat_at=? WHERE id=1 AND "
                "holder=?", (_now(), holder))
            self._adapter.commit(self._conn)
            return cur.rowcount == 1

    def release_admin_lease(self, holder: str) -> bool:
        """Clean shutdown: zero the heartbeat but keep holder and
        generation, so the next boot takes over at generation + 1."""
        with self._lock:
            cur = self._exec(
                "UPDATE admin_lease SET heartbeat_at=0 WHERE id=1 AND "
                "holder=?", (holder,))
            self._adapter.commit(self._conn)
            return cur.rowcount == 1

    def get_admin_lease(self) -> Optional[Dict[str, Any]]:
        return self._one("SELECT * FROM admin_lease WHERE id=1")


    # ---- online backup ----
    def backup(self, path: str) -> Dict[str, Any]:
        """Snapshot the live store to ``path`` with SQLite's online
        backup API (consistent under concurrent writers) and return
        ``{path, bytes}``. The copy lands in a temporary file first and
        replaces ``path`` atomically, so a crash mid-backup never leaves
        a torn snapshot there. Engines with no one-file snapshot raise
        ``NotImplementedError``."""
        db_file = getattr(self._adapter, "path", None)
        if db_file and db_file != ":memory:":
            # a connection of its own and no store lock: the backup API
            # is online, and holding the lock for the page copy would
            # stall every other caller (the lease heartbeat among them)
            conn = self._adapter.connect()
            try:
                self._adapter.backup(conn, path)
            finally:
                self._adapter.close(conn)
        else:
            # the live connection is the database
            with self._lock:
                self._adapter.backup(self._conn, path)
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        return {"path": path, "bytes": size}


def _hash_password(password: str, salt: str) -> str:
    return hashlib.pbkdf2_hmac("sha256", password.encode(),
                               bytes.fromhex(salt), 100_000).hex()
