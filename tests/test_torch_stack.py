"""The port's stack end to end on the CPU, in real subprocesses.

A user's whole flow, as ``tests/test_stack_e2e.py`` runs it on the JAX
package, on the port: the port's kvd, ``ServicesManager(platform="cpu")``
over one virtual slot, ``Admin``, ``AdminApp`` and the port ``Client``
over HTTP. Log in, upload a tiny ``ViTBase16`` (patch 4, hidden 96, depth
2, on 64 seeded 16 x 16 images) and the datasets, tune 2 trials under
BOHB with profiling on (the admin spawns an advisor service and a train
worker onto the slot), let the monitor finalize the job (the slot comes
back), deploy the best trial (an inference worker on the slot and a
Predictor), predict over HTTP, then stop everything. The advisor's first
proposal equals the JAX BOHB advisor's for the same seed and pins, and
the served probabilities equal a direct ``predict`` of the same trial's
parameters, loaded from the param store.
"""

import time
from pathlib import Path

import numpy as np
import pytest

from rafiki_tpu.advisor import make_advisor as jmake_advisor
from rafiki_tpu.model import knob as jknob
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.app import AdminApp
from rafiki_tpu_torch.admin.services_manager import ServicesManager
from rafiki_tpu_torch.client import Client
from rafiki_tpu_torch.model import knob as pknob
from rafiki_tpu_torch.models.vit import ViTBase16
from rafiki_tpu_torch.parallel.mesh import DeviceSpec
from rafiki_tpu_torch.store.meta_store import MetaStore
from rafiki_tpu_torch.store.param_store import ParamStore
from rafiki_tpu_torch.worker.inference import KERNEL_WRAPPERS

PINS = {"patch_size": 4, "hidden_dim": 96, "depth": 2, "n_heads": 4,
        "bf16": False, "batch_size": 16}
TRIALS = 2


def _images(path, n, seed, size=16, n_classes=4):
    """A learnable uint8 image set: a coarse pattern per class, plus
    noise."""
    rng = np.random.default_rng(seed)
    coarse = np.random.default_rng(7).normal(0, 1, (n_classes, 4, 4, 3))
    t = np.repeat(np.repeat(coarse, size // 4, 1), size // 4, 2)
    y = rng.integers(0, n_classes, n)
    x = t[y] + 0.5 * rng.standard_normal((n, size, size, 3))
    images = np.clip((x + 4.5) * 255 / 9, 0, 255).astype(np.uint8)
    np.savez(path, images=images, labels=y, n_classes=np.asarray(n_classes))
    return images


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_stack")
    meta = MetaStore(str(work / "meta.db"))
    manager = ServicesManager(meta, str(work / "stack"), platform="cpu",
                              devices=[DeviceSpec(id=0)], slot_timeout=120.0)
    manager.start_data_plane()
    admin = Admin(meta, manager)
    admin.start_monitor(interval_s=0.3)
    app = AdminApp(admin)
    host, port = app.start()
    try:
        yield Client(f"http://{host}:{port}", timeout=300.0), manager, work
    finally:
        app.stop()


def test_train_tune_deploy_predict_on_the_ports_stack(stack):
    client, manager, work = stack
    _images(work / "train.npz", 64, 0)
    val = _images(work / "val.npz", 32, 1)

    assert client.login("superadmin@rafiki", "rafiki")["token"]
    model = client.create_model("vit", "IMAGE_CLASSIFICATION", ViTBase16)
    ds_tr = client.create_dataset("train", "IMAGE_CLASSIFICATION",
                                  str(work / "train.npz"))
    ds_va = client.create_dataset("val", "IMAGE_CLASSIFICATION",
                                  str(work / "val.npz"))
    job = client.create_train_job(
        app="torch-e2e", task="IMAGE_CLASSIFICATION",
        train_dataset_id=ds_tr["id"], val_dataset_id=ds_va["id"],
        budget={"TRIAL_COUNT": TRIALS}, model_ids=[model["id"]],
        train_args={"advisor": "auto", "knob_overrides": PINS,
                    "profile": True})
    assert job["status"] == "RUNNING" and len(job["sub_train_jobs"]) == 1
    assert manager.allocator.free_count() == 0  # the train worker's slot

    job = client.wait_until_train_job_finished(job["id"], timeout=600,
                                               poll_s=0.3)
    assert job["status"] == "STOPPED"
    trials = client.get_trials_of_train_job(job["id"])
    assert [t["status"] for t in trials] == ["COMPLETED"] * TRIALS
    # finalized by the monitor: the advisor stopped, the slot free again
    assert manager.allocator.free_count() == 1
    assert not manager.services

    # the advisor service spawned by the admin proposed what the JAX
    # BOHB advisor proposes for the same seed and pins
    config = pknob.knob_config_to_json({
        k: (pknob.FixedKnob(PINS[k]) if k in PINS else v)
        for k, v in ViTBase16.get_knob_config().items()})
    jadv = jmake_advisor(jknob.knob_config_from_json(config), "auto",
                         total_trials=TRIALS, seed=0)
    first = jadv.propose()
    assert trials[0]["knobs"] == first.knobs
    assert trials[0]["budget_scale"] == first.budget_scale

    # one torch.profiler trace per trial, under the job's profile dir
    traces = sorted((work / "stack" / "profiles").rglob("*.json"))
    assert len(traces) == TRIALS

    best = client.get_best_trials_of_train_job(job["id"], max_count=1)[0]
    t0 = time.monotonic()
    ijob = client.create_inference_job(job["id"], max_workers=1)
    assert ijob["status"] == "RUNNING" and ijob["predictor_url"]
    assert manager.allocator.free_count() == 0
    served = client.predict(ijob["predictor_url"], list(val))
    assert time.monotonic() - t0 < 300

    direct = ViTBase16(device="cpu", **best["knobs"])
    direct.load_parameters(
        ParamStore.from_uri(manager.param_store_uri).load(best["id"]))
    want = np.asarray(direct.predict(list(val)), np.float64)
    got = np.asarray(served, np.float64)
    assert got.shape == (len(val), 4)
    np.testing.assert_array_equal(got, want)  # identical

    # the worker's published stats carry its kernel launches: all zero,
    # the plain versions ran on the CPU
    deadline = time.monotonic() + 120
    while True:
        health = client.get_inference_job_health(ijob["id"])
        stats = list(health.get("workers", {}).values())
        if stats or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    assert stats and stats[0]["kernel_launches"] == {
        name: 0 for name in KERNEL_WRAPPERS}
    assert health["queries_served"] == len(val)

    pids = [s.proc.pid for s in manager.services.values()]
    client.stop_inference_job(ijob["id"])
    assert not manager.services and manager.allocator.free_count() == 1
    for pid in pids:
        stat = Path(f"/proc/{pid}/stat")
        assert not stat.exists() or stat.read_text().split()[2] == "Z"
