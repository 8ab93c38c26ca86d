"""Port parity: ``rafiki_tpu_torch.store.meta_store`` against the JAX
``MetaStore``, through one SQLite file.

A file the port writes (train job, sub-train job, trials in every
terminal state, heartbeats, logs) must read the same through the JAX
store — rows, logs, the best trials a deploy takes — and the reverse;
the schema the port creates must be the JAX one, table for table; and a
claim for resume must be won by exactly one store of either package.
"""

import sqlite3

import pytest
import torch

from rafiki_tpu.store.meta_store import MetaStore as JMetaStore
from rafiki_tpu_torch.store.meta_store import MetaStore

torch.set_num_threads(1)


def _fill(store, job_id):
    """One sub-train job with a completed, an errored, a low-rung and a
    running trial, and logs; returns (sub id, trial ids)."""
    sub = store.create_sub_train_job(job_id, "m0")["id"]
    ids = []
    for no, (score, budget) in enumerate([(0.5, 1.0), (0.9, 1.0),
                                          (0.99, 1 / 3), (0.7, 1.0)]):
        t = store.create_trial(sub, no, model_id="m0",
                               knobs={"lr": 0.1 * (no + 1), "bf16": True},
                               worker_id="w0", budget_scale=budget,
                               shape_sig=f"[('d', {no})]")
        ids.append(t["id"])
        store.add_trial_log(t["id"], "values", {"epoch": 0, "loss": 1.5},
                            100.0 + no)
        store.add_trial_log(t["id"], "message", {"message": "hi"})
        if no != 3:
            assert store.mark_trial_completed(t["id"], score,
                                              params_saved=True)
    err = store.create_trial(sub, 4, model_id="m0", knobs={}, worker_id="w1")
    assert store.mark_trial_errored(err["id"], "boom", "preemption")
    ids.append(err["id"])
    store.heartbeat_trial(ids[3])
    store.update_trial(ids[3], knobs={"lr": 0.4, "bf16": False})
    return sub, ids


def _view(store, job_id, sub, ids):
    rows = store.get_trials_of_sub_train_job(sub)
    return {"rows": rows,
            "one": [store.get_trial(i) for i in ids],
            "logs": [store.get_trial_logs(i) for i in ids],
            "best": store.get_best_trials_of_train_job(job_id),
            "best3": store.get_best_trials_of_train_job(job_id, 3)}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_file_written_by_one_package_reads_the_same_in_the_other(
        tmp_path, writer):
    path = str(tmp_path / "meta.db")
    w = (MetaStore if writer == "port" else JMetaStore)(path)
    job = w.create_train_job("u0", "app", 1, "IMAGE_CLASSIFICATION",
                             {"TRIAL_COUNT": 5}, "tr", "va",
                             {"knob_overrides": {"depth": 2}})
    sub, ids = _fill(w, job["id"])
    want = _view(w, job["id"], sub, ids)
    for reader in (MetaStore(path), JMetaStore(path)):
        assert _view(reader, job["id"], sub, ids) == want
    jax_reader = JMetaStore(path)
    assert jax_reader.get_train_job(job["id"]) == job
    assert jax_reader.get_sub_train_job(sub)["train_job_id"] == job["id"]
    assert jax_reader.get_trials_of_train_job(job["id"]) == want["rows"]
    best = want["best"]
    assert [t["score"] for t in best] == [0.9, 0.5]  # full budget, saved
    assert want["rows"][3]["knobs"] == {"lr": 0.4, "bf16": False}
    assert want["rows"][4]["error_class"] == "preemption"
    assert want["logs"][0][0]["data"] == {"epoch": 0, "loss": 1.5}


def _schema(path):
    with sqlite3.connect(path) as conn:
        return sorted(conn.execute(
            "SELECT type, name, sql FROM sqlite_master "
            "WHERE name NOT LIKE 'sqlite_%'").fetchall())


def test_the_port_creates_the_jax_schema(tmp_path):
    MetaStore(str(tmp_path / "port.db")).close()
    JMetaStore(str(tmp_path / "jax.db")).close()
    assert _schema(str(tmp_path / "port.db")) == \
        _schema(str(tmp_path / "jax.db"))


def test_claim_for_resume_is_exclusive_across_packages(tmp_path):
    path = str(tmp_path / "meta.db")
    port, jax_store = MetaStore(path), JMetaStore(path)
    sub = port.create_sub_train_job("j", "m0")["id"]
    stale = port.create_trial(sub, 0, model_id="m0", knobs={})
    port.update_trial(stale["id"], heartbeat_at=0.0)
    assert port.claim_trial_for_resume(stale["id"], "wA") is True
    assert jax_store.claim_trial_for_resume(stale["id"], "wB") is False
    assert port.get_trial(stale["id"])["error"] == "resumed by wA"
    live = jax_store.create_trial(sub, 1, model_id="m0", knobs={})
    jax_store.heartbeat_trial(live["id"])
    assert port.claim_trial_for_resume(live["id"], "wA") is False
    det = port.create_trial(sub, 2, model_id="m0", knobs={})
    assert port.mark_trial_errored(det["id"], "bad knob")
    assert jax_store.claim_trial_for_resume(det["id"], "wB") is False
    pre = jax_store.create_trial(sub, 3, model_id="m0", knobs={})
    assert jax_store.mark_trial_errored(pre["id"], "lost", "preemption")
    assert port.claim_trial_for_resume(pre["id"], "wA") is True
    assert jax_store.get_trial(pre["id"])["error"] == "lost | resumed by wA"
    # fenced: a claimed row neither completes nor errors
    assert port.mark_trial_completed(pre["id"], 1.0, True) is False
    assert port.mark_trial_errored(pre["id"], "late") is False
    with pytest.raises(KeyError):
        port.update_trial("nope", score=1.0)


def test_other_backends_raise_naming_themselves():
    with pytest.raises(NotImplementedError, match="PostgreSQL"):
        MetaStore("postgresql://localhost/rafiki")
    store = MetaStore("sqlite:///:memory:")
    assert store.get_trial("x") is None
