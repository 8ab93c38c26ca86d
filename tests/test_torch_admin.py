"""The port's control plane: device slots, the card probe, the meta
store's admin surface, ``Admin`` / ``AdminApp`` through the port
``Client``, the advisor service, and model-class transport.

- Slots split the host's CUDA indices in order and hand each worker its
  ``CUDA_VISIBLE_DEVICES``; the probe raises without a card unless a CPU
  stack is asked for, and so do the workers' ``main`` given
  ``"device": "cuda"`` and ``AdminApp``'s ``main``.
- The port's ``MetaStore`` and the JAX one share one sqlite file: each
  writes what the other reads (users and their passwords, models,
  datasets, jobs, services, respawn budgets, the admin lease).
- ``AdminApp`` answers the JAX route table; job creation validates at
  the API (the autoscale keys with JAX's messages), auth is enforced,
  and the one option still refused (``PAGED_KERNEL=false``) is refused
  by name before anything spawns; ``RAFIKI_CHAOS`` arms the admin's
  kill timer. The port ``Client`` drives a JAX admin
  and the JAX ``Client`` a port admin.
- A toy model's whole job runs through the port's stack in real
  subprocesses (advisor, train worker, inference worker, predictor, the
  port's kvd): the manager's spawn path, slot release and the monitor.
- The port's ``AdvisorService`` over HTTP proposes what the JAX one
  proposes for the same seed and feedback.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from rafiki_tpu.admin.admin import Admin as JAdmin
from rafiki_tpu.admin.app import AdminApp as JAdminApp
from rafiki_tpu.admin.services_manager import ServicesManager as JManager
from rafiki_tpu.advisor import make_advisor as jmake_advisor
from rafiki_tpu.advisor.base import TrialResult as JTrialResult
from rafiki_tpu.advisor.service import AdvisorClient as JAdvisorClient
from rafiki_tpu.advisor.service import AdvisorService as JAdvisorService
from rafiki_tpu.client import Client as JClient
from rafiki_tpu.model import knob as jknob
from rafiki_tpu.model.base import serialize_model_class as jserialize
from rafiki_tpu.parallel.mesh import DeviceSpec as JDeviceSpec
from rafiki_tpu.store.meta_store import MetaStore as JMetaStore
from rafiki_tpu_torch import constants as pconst
from rafiki_tpu_torch.admin import device_probe
from rafiki_tpu_torch.admin import services_manager as psm
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.app import AdminApp
from rafiki_tpu_torch.advisor.base import TrialResult
from rafiki_tpu_torch.advisor.service import AdvisorClient, AdvisorService
from rafiki_tpu_torch.advisor import make_advisor
from rafiki_tpu_torch.client import Client
from rafiki_tpu_torch.model import knob as pknob
from rafiki_tpu_torch.model.base import (load_model_class,
                                         serialize_model_class)
from rafiki_tpu_torch.models.vit import ViTBase16
from rafiki_tpu_torch.parallel.mesh import (DeviceSpec, SubMeshAllocator,
                                            partition_devices, slot_env_vars)
from rafiki_tpu_torch.store.meta_store import MetaStore
from rafiki_tpu_torch.utils.http import HttpStatusError, json_request

ROOT = Path(__file__).resolve().parent.parent

#: a model module the admin accepts and a worker serves: no torch model,
#: so a whole job runs in seconds
TOY_MODULE = '''
import numpy as np
from rafiki_tpu_torch.model.knob import FixedKnob, FloatKnob, PolicyKnob
from rafiki_tpu_torch.model.base import TrainContext, validate_template_knobs


class StackToy:
    @staticmethod
    def get_knob_config():
        return {"max_epochs": FixedKnob(3),
                "lr": FloatKnob(0.01, 1.0, is_exp=True),
                "quick_train": PolicyKnob("QUICK_TRAIN"),
                "share_params": PolicyKnob("SHARE_PARAMS")}

    @classmethod
    def validate_knobs(cls, knobs):
        validate_template_knobs(cls, knobs)

    def __init__(self, device=None, **knobs):
        self.knobs, self._w = dict(knobs), 0.0

    def train(self, dataset_path, ctx=None):
        ctx = ctx or TrainContext()
        for epoch in range(max(1, round(3 * ctx.budget_scale))):
            self._w += self.knobs["lr"]
            ctx.logger.log(epoch=epoch, loss=1.0 / (1 + self._w))

    def evaluate(self, dataset_path):
        return float(self._w)

    def predict(self, queries):
        return [[self._w, float(np.sum(q))] for q in queries]

    def dump_parameters(self):
        return {"w": np.asarray(self._w)}

    def load_parameters(self, params):
        self._w = float(params["w"])
'''


# ---- slots, CUDA_VISIBLE_DEVICES, the probe

def test_slots_partition_cuda_indices_in_order():
    devs = [DeviceSpec(id=i, platform="cuda") for i in (3, 0, 2, 1)]
    assert [[d.id for d in s] for s in partition_devices(devs, 2)] == \
        [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="must divide"):
        partition_devices(devs, 3)
    alloc = SubMeshAllocator(devs, 2)
    a, b = alloc.acquire(0.0), alloc.acquire(0.0)
    assert (a.index, b.index, alloc.free_count()) == (0, 1, 0)
    assert alloc.acquire(timeout=0.05) is None
    assert slot_env_vars("cuda", a) == {"CUDA_VISIBLE_DEVICES": "0,1"}
    assert slot_env_vars("cuda", b) == {"CUDA_VISIBLE_DEVICES": "2,3"}
    # control-plane children and a CPU stack's workers see no card
    assert slot_env_vars("cuda", None) == {"CUDA_VISIBLE_DEVICES": ""}
    assert slot_env_vars("cpu", a) == {"CUDA_VISIBLE_DEVICES": ""}
    with pytest.raises(ValueError):
        slot_env_vars("tpu", a)
    alloc.release(b)
    with pytest.raises(ValueError, match="already free"):
        alloc.release(b)
    assert alloc.acquire(0.0).index == 1


def test_device_spec_from_probe():
    d = DeviceSpec.from_probe({"id": 1, "platform": "cuda",
                               "name": "NVIDIA H100 80GB HBM3",
                               "memory_bytes": 85 * 2**30})
    assert (d.id, d.platform, d.memory_bytes) == (1, "cuda", 85 * 2**30)


def test_probe_lists_the_cards(monkeypatch):
    class Props:
        name, total_memory = "NVIDIA H100 80GB HBM3", 85_000_000_000

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props())
    assert device_probe.probe() == {"platform": "cuda", "devices": [
        {"id": i, "platform": "cuda", "name": Props.name,
         "memory_bytes": Props.total_memory} for i in range(2)]}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_probe.probe() == {"platform": "none", "devices": []}


def test_manager_raises_without_a_card_unless_cpu_is_asked_for(
        tmp_path, monkeypatch):
    """The real probe subprocess, on a host where it sees no card."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    meta = MetaStore(":memory:")
    for platform in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            psm.ServicesManager(meta, str(tmp_path), platform=platform)
    m = psm.ServicesManager(meta, str(tmp_path), platform="cpu",
                            devices=[DeviceSpec(id=i) for i in range(2)])
    assert (m.platform, m.worker_device, m.allocator.n_slots) == \
        ("cpu", "cpu", 2)
    with pytest.raises(ValueError, match="unknown platform"):
        psm.ServicesManager(meta, str(tmp_path), platform="tpu")


def test_manager_on_a_probed_card(tmp_path, monkeypatch):
    monkeypatch.setattr(psm, "probe_devices", lambda: {
        "platform": "cuda", "devices": [
            {"id": 0, "platform": "cuda", "name": "H100",
             "memory_bytes": 1}]})
    m = psm.ServicesManager(MetaStore(":memory:"), str(tmp_path),
                            slot_size=1)
    assert (m.platform, m.worker_device, m.allocator.n_slots) == \
        ("cuda", "cuda", 1)


def test_spawn_targets_are_the_ports_modules():
    assert sorted(psm.SPAWN_TARGETS.values()) == [
        "rafiki_tpu_torch.advisor.service",
        "rafiki_tpu_torch.serving.predictor",
        "rafiki_tpu_torch.worker.inference",
        "rafiki_tpu_torch.worker.train"]


@pytest.mark.parametrize("which", ["inference", "train"])
def test_worker_main_given_a_card_that_is_not_there_raises(tmp_path,
                                                           which,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "toy.py").write_text(TOY_MODULE)
    cfg = {"model_file": str(tmp_path / "toy.py"),
           "model_class": "StackToy", "device": "cuda",
           "param_store_uri": f"file://{tmp_path / 'params'}",
           "trial_id": "t0", "knobs": {}, "kv_host": "127.0.0.1",
           "kv_port": 1, "worker_id": "w0", "advisor_url": "http://x:1",
           "train_dataset": "tr", "val_dataset": "va"}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    if which == "inference":
        from rafiki_tpu_torch.worker.inference import main
    else:
        from rafiki_tpu_torch.worker.train import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", str(path)])


def test_app_main_without_a_cpu_flag_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # the probe sees no card
    cfg = tmp_path / "admin.json"
    cfg.write_text(json.dumps({"workdir": str(tmp_path / "w"),
                               "db_path": str(tmp_path / "meta.db")}))
    from rafiki_tpu_torch.admin.app import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", str(cfg)])


def test_app_main_arms_the_chaos_admin_kill(tmp_path):
    """``RAFIKI_CHAOS=kill_admin_after_s=...`` arms the admin's own
    SIGKILL timer, as the JAX admin's ``main`` does: the stack boots and
    serves, then the process dies by SIGKILL with no clean shutdown (its
    lease is left unreleased and its kvd alive, for a successor to
    adopt)."""
    port_file = tmp_path / "admin.port"
    cfg = tmp_path / "admin.json"
    cfg.write_text(json.dumps({
        "workdir": str(tmp_path / "w"), "db_path": str(tmp_path / "m.db"),
        "platform": "cpu", "port_file": str(port_file)}))
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               RAFIKI_CHAOS="kill_admin_after_s=3")
    log = tmp_path / "admin.log"
    with open(log, "w") as f:  # not a pipe: the kvd child inherits it
        proc = subprocess.Popen(
            [sys.executable, "-m", "rafiki_tpu_torch.admin.app",
             "--config", str(cfg)], env=env, stdout=f,
            stderr=subprocess.STDOUT, cwd=str(tmp_path))
    kvd_pid = 0
    try:
        proc.wait(timeout=120)
        rows = MetaStore(str(tmp_path / "m.db")).get_services("RUNNING")
        kvd_pid = int(rows[0]["pid"]) if rows else 0
    finally:
        if proc.poll() is None:
            proc.kill()
        if kvd_pid:
            os.kill(kvd_pid, signal.SIGKILL)
    out = log.read_text()
    assert proc.returncode == -signal.SIGKILL, out
    assert port_file.read_text().strip() and "admin on" in out
    assert "admin stopped cleanly" not in out
    assert kvd_pid and rows[0]["service_type"] == "DATA_PLANE"
    lease = MetaStore(str(tmp_path / "m.db")).get_admin_lease()
    assert lease["heartbeat_at"] > 0  # never released


def test_app_main_serves_a_cpu_stack_and_stops_on_sigterm(tmp_path):
    port_file = tmp_path / "admin.port"
    cfg = tmp_path / "admin.json"
    cfg.write_text(json.dumps({
        "workdir": str(tmp_path / "w"), "db_path": str(tmp_path / "m.db"),
        "platform": "cpu", "cpu_slots": 2, "port_file": str(port_file)}))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "rafiki_tpu_torch.admin.app", "--config",
         str(cfg)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=str(tmp_path))
    try:
        deadline = time.monotonic() + 120
        while not (port_file.exists() and port_file.read_text().strip()):
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline
            time.sleep(0.1)
        url = f"http://127.0.0.1:{port_file.read_text().strip()}"
        health = Client(url)._call("GET", "/health")
        assert health["ok"] and health["platform"] == "cpu"
        assert health["free_slots"] == 2 and health["data_plane"]["up"]
        kvd_pid = MetaStore(str(tmp_path / "m.db")).get_services(
            "RUNNING")[0]["pid"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "admin stopped cleanly" in out
    assert not Path(f"/proc/{kvd_pid}").exists()
    lease = MetaStore(str(tmp_path / "m.db")).get_admin_lease()
    assert lease["heartbeat_at"] == 0  # released on the way out


# ---- one meta store file, two packages

def test_meta_stores_read_each_others_rows(tmp_path):
    path = str(tmp_path / "meta.db")
    p, j = MetaStore(path), JMetaStore(path)
    u = p.create_user("dev@x", "pw-1", pconst.UserType.MODEL_DEVELOPER)
    assert j.authenticate_user("dev@x", "pw-1")["id"] == u["id"]
    assert j.authenticate_user("dev@x", "nope") is None
    ju = j.create_user("app@x", "pw-2", "APP_DEVELOPER")
    assert p.authenticate_user("app@x", "pw-2")["id"] == ju["id"]
    p.ban_user(ju["id"])
    assert j.authenticate_user("app@x", "pw-2") is None

    m = p.create_model(u["id"], "toy", "IMAGE_CLASSIFICATION", "Toy",
                       b"\x00src", access_right="PUBLIC")
    assert j.get_model(m["id"])["model_bytes"] == b"\x00src"
    assert j.get_model_by_name(u["id"], "toy")["id"] == m["id"]
    jm = j.create_model(ju["id"], "j", "IMAGE_CLASSIFICATION", "J", b"j")
    assert [x["id"] for x in p.get_available_models(
        "IMAGE_CLASSIFICATION", user_id=u["id"])] == [m["id"]]
    assert {x["id"] for x in p.get_available_models(
        user_id=ju["id"])} == {m["id"], jm["id"]}

    d = j.create_dataset(u["id"], "tr", "IMAGE_CLASSIFICATION", "/d/tr",
                         stat={"n": 3})
    assert p.get_dataset(d["id"])["uri"] == "/d/tr"
    assert [x["id"] for x in p.get_datasets(u["id"], "IMAGE_CLASSIFICATION")
            ] == [d["id"]]

    job = p.create_train_job(u["id"], "app", 1, "IMAGE_CLASSIFICATION",
                             {"TRIAL_COUNT": 2}, "/d/tr", "/d/va",
                             train_args={"advisor": "bohb"})
    p.update_train_job(job["id"], status="RUNNING")
    jj = j.get_train_job(job["id"])
    assert (jj["status"], jj["budget"], jj["train_args"]) == (
        "RUNNING", {"TRIAL_COUNT": 2}, {"advisor": "bohb"})
    j.create_train_job(u["id"], "app", 2, "IMAGE_CLASSIFICATION", {},
                       "a", "b")
    assert p.get_latest_train_job_of_app(u["id"], "app")["app_version"] \
        == 2
    assert [x["app_version"] for x in p.get_train_jobs_of_user(u["id"])] \
        == [2, 1]
    sub = j.create_sub_train_job(job["id"], m["id"])
    p.update_sub_train_job(sub["id"], status="STOPPED")
    assert j.get_sub_train_job(sub["id"])["status"] == "STOPPED"
    assert [s["id"] for s in p.get_sub_train_jobs_of_train_job(job["id"])
            ] == [sub["id"]]
    t = p.create_trial(sub["id"], 0, m["id"], {"lr": 0.1})
    assert [x["id"] for x in j.get_trials_of_train_job(job["id"])] == \
        [t["id"]]
    assert [x["id"] for x in p.get_trials_of_train_job(job["id"])] == \
        [t["id"]]

    ij = j.create_inference_job(u["id"], job["id"], budget={"X": 1})
    p.update_inference_job(ij["id"], status="RUNNING",
                           predictor_host="127.0.0.1:9")
    assert j.get_inference_job(ij["id"])["predictor_host"] == "127.0.0.1:9"
    assert [x["id"] for x in p.get_inference_jobs_of_train_job(job["id"])
            ] == [ij["id"]]
    assert [x["id"] for x in p.get_inference_jobs(u["id"])] == [ij["id"]]

    spec = {"module": "rafiki_tpu_torch.worker.train", "config": {"a": 1},
            "service_type": "TRAIN_WORKER", "needs_slot": True,
            "meta_kwargs": {"train_job_id": job["id"]}}
    s = p.create_service("TRAIN_WORKER", train_job_id=job["id"],
                         pid=123, devices=[0], spawn_spec=spec,
                         start_time=42.0)
    js = j.get_service(s["id"])
    assert (js["spawn_spec"], js["devices"], js["start_time"]) == (
        spec, "[0]", 42.0)
    j.update_service(s["id"], status="RUNNING", spawn_spec={"x": 2})
    assert p.get_service(s["id"])["spawn_spec"] == {"x": 2}
    assert [x["id"] for x in p.get_services("RUNNING")] == [s["id"]]

    assert p.incr_respawn_count("TRAIN_WORKER", job["id"]) == 1
    assert j.incr_respawn_count("TRAIN_WORKER", job["id"]) == 2
    assert p.get_respawn_counts() == j.get_respawn_counts() == \
        {f"TRAIN_WORKER:{job['id']}": 2}


def test_admin_lease_is_one_lease_across_the_packages(tmp_path):
    path = str(tmp_path / "meta.db")
    p, j = MetaStore(path), JMetaStore(path)
    assert p.acquire_admin_lease("port", ttl_s=30) == {
        "holder": "port", "generation": 1, "took_over": False}
    assert j.acquire_admin_lease("jax", ttl_s=30) is None  # live: fenced
    assert p.renew_admin_lease("port")
    assert p.release_admin_lease("port")
    got = j.acquire_admin_lease("jax", ttl_s=30)
    assert got == {"holder": "jax", "generation": 2, "took_over": True}
    assert not p.renew_admin_lease("port")  # fenced out
    assert p.get_admin_lease()["holder"] == "jax"
    m = psm.ServicesManager(p, str(tmp_path / "w"), platform="cpu")
    with pytest.raises(psm.LeaseHeldError, match="generation 2"):
        m.acquire_lease()


def test_fenced_manager_refuses_to_spawn(tmp_path):
    meta = MetaStore(str(tmp_path / "meta.db"))
    m = psm.ServicesManager(meta, str(tmp_path / "w"), platform="cpu")
    m.acquire_lease(ttl_s=30)
    meta.release_admin_lease(m.lease_holder)
    JMetaStore(str(tmp_path / "meta.db")).acquire_admin_lease("other")
    assert m.renew_lease() is False and m.fenced
    with pytest.raises(psm.AdminFencedError):
        m.start_data_plane()
    m.stop_all()


# ---- Admin and AdminApp through the port Client

@pytest.fixture()
def app(tmp_path):
    meta = MetaStore(str(tmp_path / "meta.db"))
    manager = psm.ServicesManager(meta, str(tmp_path / "stack"),
                                  platform="cpu",
                                  devices=[DeviceSpec(id=0)])
    admin = Admin(meta, manager)
    application = AdminApp(admin)
    host, port = application.start()
    client = Client(f"http://{host}:{port}")
    client.login("superadmin@rafiki", "rafiki")
    (tmp_path / "toy.py").write_text(TOY_MODULE)
    yield client, meta, manager, tmp_path
    application.stop()


def test_route_table_is_the_jax_admins(app, tmp_path):
    client, *_ = app
    jmeta = JMetaStore(str(tmp_path / "jmeta.db"))
    jm = JManager(jmeta, str(tmp_path / "jstack"), platform="cpu",
                  devices=[JDeviceSpec(id=0)])
    japp = JAdminApp(JAdmin(jmeta, jm))
    port_app = AdminApp(Admin(MetaStore(":memory:"),
                              psm.ServicesManager(
                                  MetaStore(":memory:"), str(tmp_path / "x"),
                                  platform="cpu")))
    routes = lambda a: sorted((m, p.pattern) for m, p, _h in a.http._routes)
    assert routes(port_app) == routes(japp)


def _toy_model(client, tmp_path):
    return client.create_model_raw(
        "toy", "IMAGE_CLASSIFICATION", "StackToy",
        (tmp_path / "toy.py").read_bytes())


def test_auth_is_enforced(app):
    client, *_ = app
    anon = Client(client.admin_url)
    with pytest.raises(HttpStatusError) as ei:
        anon.get_models()
    assert ei.value.status == 401
    with pytest.raises(HttpStatusError) as ei:
        anon.login("superadmin@rafiki", "wrong")
    assert ei.value.status == 401
    u = client.create_user("dev@x", "pw", "MODEL_DEVELOPER")
    assert u["user_type"] == "MODEL_DEVELOPER"
    dev = Client(client.admin_url)
    assert dev.login("dev@x", "pw")["user_id"] == u["id"]
    assert dev.get_models() == []


def test_models_datasets_and_job_validation(app):
    client, meta, manager, tmp_path = app
    m = _toy_model(client, tmp_path)
    assert [x["id"] for x in client.get_models("IMAGE_CLASSIFICATION")] == \
        [m["id"]]
    with pytest.raises(HttpStatusError) as ei:  # not a model template
        client.create_model_raw("bad", "IMAGE_CLASSIFICATION", "Nope",
                                b"x = 1\n")
    assert ei.value.status == 400
    ds = client.create_dataset("tr", "IMAGE_CLASSIFICATION", "unused")
    with pytest.raises(HttpStatusError) as ei:
        client.create_train_job("app", "IMAGE_CLASSIFICATION",
                                "no-such-ds", ds["id"])
    assert ei.value.status == 400 and "no-such-ds" in str(ei.value)
    with pytest.raises(HttpStatusError) as ei:  # a typo'd pin
        client.create_train_job("app", "IMAGE_CLASSIFICATION", ds["id"],
                                ds["id"], model_ids=[m["id"]],
                                train_args={"knob_overrides": {"lrr": 1}})
    assert ei.value.status == 400 and "lrr" in str(ei.value)
    job = client.get_train_job_of_app("app")
    assert job["status"] == "ERRORED" and not manager.services
    assert manager.allocator.free_count() == 1


DEFERRED = [
    ("PAGED_KERNEL", {"PAGED_KERNEL": "false"}),
]


@pytest.mark.parametrize("name,budget", DEFERRED,
                         ids=[n for n, _ in DEFERRED])
def test_deferred_inference_options_are_refused_by_name(app, name, budget):
    client, meta, manager, _ = app
    job = meta.create_train_job("u", "app", 1, "IMAGE_CLASSIFICATION", {},
                                "a", "b")
    with pytest.raises(HttpStatusError) as ei:
        client.create_inference_job(job["id"], budget=budget)
    assert ei.value.status == 400
    assert name in str(ei.value) and "not ported" in str(ei.value)
    assert not manager.services and manager.allocator.free_count() == 1
    ij = meta.get_inference_jobs_of_train_job(job["id"])[0]
    assert ij["status"] == "ERRORED"


def _lm_job(meta, shapes=("s1", "s1", "s2"), task="LANGUAGE_MODELING"):
    """A train job of one model with completed trials (best first) of the
    given shape signatures, as the manager's deploy path reads them."""
    name = f"lm-{task}-{len(meta.get_available_models(user_id='u'))}"
    m = meta.create_model("u", name, task, "LlamaLoRA", b"x")
    job = meta.create_train_job("u", name, 1, task, {}, "a", "b")
    sub = meta.create_sub_train_job(job["id"], m["id"])
    trials = []
    for i, sig in enumerate(shapes):
        t = meta.create_trial(sub["id"], i, m["id"], {"max_len": 32,
                                                      "i": i},
                              shape_sig=sig)
        meta.mark_trial_completed(t["id"], 1.0 - 0.1 * i, True)
        trials.append(t)
    return job, m, trials


@pytest.mark.parametrize("budget,initial", [
    ({"AUTOSCALE": 1}, 1),
    ({"MAX_WORKERS": 3}, 1),
    ({"AUTOSCALE": 1, "MIN_WORKERS": 2, "MAX_WORKERS": 3}, 1),
    ({"AUTOSCALE": 1, "MAX_WORKERS": 2, "AUTOSCALE_COOLDOWN_S": 0}, 1),
], ids=["AUTOSCALE", "MAX_WORKERS", "initial_outside_bounds",
        "cooldown_0"])
def test_autoscale_budget_keys_validated_as_jax_does(app, budget, initial):
    """The autoscale keys are served: a bad bound fails the create call
    with JAX's ``AutoscaleConfig.from_budget`` message, before anything
    spawns or a slot is taken."""
    from rafiki_tpu.admin.autoscaler import AutoscaleConfig as JConfig

    client, meta, manager, _ = app
    job, _m, _t = _lm_job(meta)
    with pytest.raises(ValueError) as want:
        JConfig.from_budget(budget, initial)
    with pytest.raises(HttpStatusError) as ei:
        client.create_inference_job(job["id"], max_workers=initial,
                                    budget=budget)
    assert ei.value.status == 400 and str(want.value) in str(ei.value)
    assert "not ported" not in str(ei.value)
    assert not manager.services and manager.allocator.free_count() == 1


def test_autoscale_over_an_ensemble_is_refused_as_jax_does(app):
    """Autoscale over replicas of DISTINCT best trials (an ensemble) is
    refused at create with the JAX manager's message; one replica of the
    best trial is the autoscaled deployment."""
    client, meta, manager, _ = app
    job, _m, _t = _lm_job(meta)
    with pytest.raises(HttpStatusError) as ei:
        client.create_inference_job(
            job["id"], max_workers=2,
            budget={"AUTOSCALE": 1, "MAX_WORKERS": 3})
    assert ei.value.status == 400
    assert "AUTOSCALE requires a single-replica deployment (this create " \
        "would spawn 2 workers" in str(ei.value)
    assert not manager.services and manager.allocator.free_count() == 1


@pytest.mark.parametrize("budget,message", [
    ({"SPECULATE_K": 1},
     "SPECULATE_K=1 must be >= 2 (draft window depth; 1 would verify "
     "nothing)"),
    ({"DRAFT_TRIAL_ID": "t1"},
     "DRAFT_TRIAL_ID requires SPECULATE_K >= 2 (the draft window depth) "
     "in the same budget"),
    ({"SPECULATE_K": 4, "DRAFT_TRIAL_ID": "no-such-trial"},
     "DRAFT_TRIAL_ID 'no-such-trial' names no trial"),
], ids=["speculate_k_1", "draft_without_speculate_k", "draft_trial_missing"])
def test_speculation_budget_keys_validated_as_jax_does(app, budget,
                                                       message):
    """The JAX manager's checks of SPECULATE_K / DRAFT_TRIAL_ID, with its
    messages, at the create call: nothing spawns, no slot is taken."""
    client, meta, manager, _ = app
    job, _m, _t = _lm_job(meta)
    with pytest.raises(HttpStatusError) as ei:
        client.create_inference_job(job["id"], budget=budget)
    assert ei.value.status == 400 and message in str(ei.value)
    assert not manager.services and manager.allocator.free_count() == 1


def test_speculation_on_an_image_job_and_a_foreign_draft_are_refused(app):
    client, meta, manager, _ = app
    job, _m, _t = _lm_job(meta, task="IMAGE_CLASSIFICATION")
    with pytest.raises(HttpStatusError) as ei:
        client.create_inference_job(job["id"], budget={"SPECULATE_K": 4})
    assert "SPECULATE_K/DRAFT_TRIAL_ID require a language-modeling " \
        "deployment" in str(ei.value)
    lm_job, lm_model, _t = _lm_job(meta)
    other_job, other_model, other = _lm_job(meta, shapes=("s9",))
    with pytest.raises(HttpStatusError) as ei:
        client.create_inference_job(lm_job["id"], budget={
            "SPECULATE_K": 4, "DRAFT_TRIAL_ID": other[0]["id"]})
    assert f"is a different model ({other_model['id']}) than the " \
        f"deployed {lm_model['id']}" in str(ei.value)
    assert not manager.services


@pytest.mark.parametrize("budget,message", [
    ({"WORKER_ROLE": "prefill,decode,prefil"},
     "WORKER_ROLE: unknown worker role 'prefil' (one of: unified, "
     "prefill, decode)"),
    ({"WORKER_ROLE": "prefill,decode,decode"},
     "WORKER_ROLE names 3 roles for 2 workers (one per worker, or a "
     "single role for all)"),
    ({"WORKER_ROLE": "prefill"},
     "WORKER_ROLE: an all-prefill pool serves nothing — at least one "
     "worker must be decode or unified"),
    ({"KV_WAIT_S": 1.0},
     "KV_WAIT_S requires WORKER_ROLE in the same budget (it tunes the "
     "disaggregated decode leg)"),
    ({"WORKER_ROLE": "decode", "KV_WAIT_S": -1},
     "KV_WAIT_S=-1.0 must be >= 0"),
    ({"HOST_KV_PAGES": 8},
     "HOST_KV_PAGES requires KV_PAGE_SIZE in the same budget (pages are "
     "the host tier's transfer unit)"),
    ({"HOST_KV_PAGES": -2, "KV_PAGE_SIZE": 8},
     "HOST_KV_PAGES=-2 must be >= 1 (host-tier page count)"),
], ids=["WORKER_ROLE", "WORKER_ROLE_count", "WORKER_ROLE_all_prefill",
        "KV_WAIT_S", "KV_WAIT_S_negative", "HOST_KV_PAGES",
        "HOST_KV_PAGES_negative"])
def test_disaggregation_budget_keys_validated_as_jax_does(app, budget,
                                                          message):
    """WORKER_ROLE, KV_WAIT_S and HOST_KV_PAGES are served with the JAX
    manager's checks and messages, at the create call: nothing spawns,
    no slot is taken, the job is ERRORED."""
    client, meta, manager, _ = app
    job, _m, _t = _lm_job(meta)
    with pytest.raises(HttpStatusError) as ei:
        client.create_inference_job(job["id"], budget=budget)
    assert ei.value.status == 400 and message in str(ei.value)
    assert not manager.services and manager.allocator.free_count() == 1
    ij = meta.get_inference_jobs_of_train_job(job["id"])[0]
    assert ij["status"] == "ERRORED"


def test_disaggregation_keys_reach_the_worker_configs(app):
    """WORKER_ROLE (per worker index), HOST_KV_PAGES and KV_WAIT_S land in
    the workers' configs as the JAX manager writes them (a unified role
    writes none); a role on an image job is refused with JAX's
    message."""
    client, meta, manager, _ = app
    job, _m, trials = _lm_job(meta)
    budget = {"WORKER_ROLE": "prefill, decode,unified", "KV_PAGE_SIZE": 8,
              "HOST_KV_PAGES": 16, "KV_WAIT_S": 2.5}
    cfgs = [manager._inference_worker_config("ij", i, t, budget,
                                             n_workers=3)
            for i, t in enumerate(trials)]
    assert [c.get("role") for c in cfgs] == ["prefill", "decode", None]
    assert {(c["host_kv_pages"], c["kv_wait_s"], c["kv_page_size"])
            for c in cfgs} == {(16, 2.5, 8)}
    one = manager._inference_worker_config(
        "ij", 0, trials[0], {"WORKER_ROLE": "decode"}, n_workers=3)
    assert one["role"] == "decode" and "kv_wait_s" not in one
    assert not {"role", "host_kv_pages", "kv_wait_s"} & set(
        manager._inference_worker_config("ij", 0, trials[0], {}))
    ijob, _m, _t = _lm_job(meta, task="IMAGE_CLASSIFICATION")
    with pytest.raises(HttpStatusError) as ei:
        client.create_inference_job(ijob["id"],
                                    budget={"WORKER_ROLE": "decode"})
    assert "WORKER_ROLE requires a language-modeling deployment (the " \
        "decode loop owns the KV shipments); task IMAGE_CLASSIFICATION " \
        "serves through the micro-batcher" in str(ei.value)
    assert not manager.services and manager.allocator.free_count() == 1


def test_decode_mode_keys_reach_the_worker_config(app):
    """SYSTEM_PREFIX, SPECULATE_K and DRAFT_TRIAL_ID (with the draft
    trial's own knobs) land in the worker's config as JAX writes them."""
    _, meta, manager, _ = app
    job, _m, trials = _lm_job(meta)
    budget = {"SYSTEM_PREFIX": "be brief", "SPECULATE_K": 4,
              "DRAFT_TRIAL_ID": trials[2]["id"]}
    cfg = manager._inference_worker_config("ij", 0, trials[0], budget)
    assert (cfg["system_prefix"], cfg["speculate_k"],
            cfg["draft_trial_id"], cfg["draft_knobs"]) == (
        "be brief", 4, trials[2]["id"], {"max_len": 32, "i": 2})
    assert cfg["pool_id"] == "ij"
    plain = manager._inference_worker_config("ij", 0, trials[0], {})
    assert not {"system_prefix", "speculate_k",
                "draft_trial_id"} & set(plain)


def test_multi_adapter_stacks_trials_of_one_model_and_shape(app, caplog):
    """MULTI_ADAPTER: the best trials sharing the primary's model and
    shape signature go to one worker (the others dropped with a
    warning); an image job, or no second stackable trial, deploys plain
    replicas with a warning."""
    _, meta, manager, _ = app
    job, _m, trials = _lm_job(meta)
    best = meta.get_best_trials_of_train_job(job["id"], max_count=3)
    got, multi = manager._multi_adapter_trials(best, {"MULTI_ADAPTER": 1})
    assert multi and [t["id"] for t in got] == [t["id"]
                                                for t in trials[:2]]
    assert "dropping 1 best trial" in caplog.text
    assert manager._multi_adapter_trials(best, {}) == (best, False)
    ijob, _m, _t = _lm_job(meta, task="IMAGE_CLASSIFICATION")
    ibest = meta.get_best_trials_of_train_job(ijob["id"], max_count=3)
    assert manager._multi_adapter_trials(
        ibest, {"MULTI_ADAPTER": 1}) == (ibest, False)
    assert "not a language-modeling job; deploying plain replicas" \
        in caplog.text
    sjob, _m, _t = _lm_job(meta, shapes=("a", "b"))
    sbest = meta.get_best_trials_of_train_job(sjob["id"], max_count=2)
    assert manager._multi_adapter_trials(
        sbest, {"MULTI_ADAPTER": 1}) == (sbest, False)
    assert "no other best trial shares model" in caplog.text


@pytest.mark.parametrize("route,body,what", [
    ("/inference_jobs/j1/rolling_restart", {}, "rolling restart"),
    ("/inference_jobs/j1/scale", {"workers": 2}, "scale-out"),
    ("/system/backup", {"path": "/tmp/b.db"}, "backup"),
])
def test_deferred_routes_answer_400_naming_themselves(app, route, body,
                                                      what):
    """The routes once refused are served: a restart or a scale of a
    RUNNING job with no live worker is the reference's 400 naming that,
    and the backup writes its snapshot (``tests/test_torch_recovery.py``
    and ``tests/test_torch_scaleout.py`` drive them further)."""
    client, meta, _manager, tmp_path = app
    job = meta.create_inference_job("u", "t", budget={})
    meta.update_inference_job(job["id"], status="RUNNING")
    route = route.replace("j1", job["id"])
    if what == "backup":
        body = {"path": str(tmp_path / "b.db")}
        got = client._call("POST", route, body)
        assert got["ok"] and got["path"] == body["path"]
        assert got["bytes"] == os.path.getsize(body["path"]) > 0
        assert MetaStore(body["path"]).get_inference_job(job["id"])
        return
    with pytest.raises(HttpStatusError) as ei:
        client._call("POST", route, body)
    assert ei.value.status == 400
    assert "no live inference workers for job" in str(ei.value)
    assert "not ported" not in str(ei.value)


def test_manager_calls_over_an_empty_store(app):
    """Scale-out, the autoscaler's state, the reconciler, the cold-start
    reaper and the rolling restart, over an empty store: a scale names
    the missing pool as JAX's does, the autoscaler reports no pool, and
    reconcile and reap find nothing."""
    _, _, manager, _ = app
    with pytest.raises(KeyError, match="no live inference workers"):
        manager.scale_inference_job("j", 2)
    with pytest.raises(ValueError, match="must be >= 1"):
        manager.scale_inference_job("j", 0)
    want = {"enabled": False, "pool": [], "warming": [], "victim": None}
    assert manager.scaleout_status("j") == want
    with pytest.raises(HttpStatusError) as ei:
        app[0].get_inference_job_autoscaler("x")
    assert ei.value.status == 400 and "no inference job 'x'" in \
        str(ei.value)
    job = app[1].create_inference_job("u", "t", budget={})
    assert app[0].get_inference_job_autoscaler(job["id"]) == want
    assert manager.autoscale_tick(force=True) == []  # no data plane yet
    rec = manager.reconcile()
    assert {k: rec[k] for k in ("services_adopted", "services_crashed",
                                "orphans_reaped", "kv_adopted")} == {
        "services_adopted": 0, "services_crashed": 0, "orphans_reaped": 0,
        "kv_adopted": 0}
    assert rec["fenced"] is False and rec["last_recovery_at"] > 0
    assert manager.reap_stale_services() == 0
    with pytest.raises(KeyError, match="no live inference workers"):
        manager.rolling_restart("j")


def test_health_and_metrics(app):
    client, _, manager, _ = app
    manager.start_data_plane()
    h = client._call("GET", "/health")
    assert h["ok"] and h["free_slots"] == 1 and h["n_services"] == 0
    assert h["data_plane"]["up"] and h["data_plane"]["stats"]["keys"] == 0
    import urllib.request

    with urllib.request.urlopen(client.admin_url + "/metrics",
                                timeout=30) as r:
        text = r.read().decode()
    assert "admin_free_slots 1" in text and "kvd_up 1" in text
    for key in ("ups", "downs", "blocked"):
        assert f"admin_autoscale_{key} 0" in text
    assert h["scaling"] == {"autoscale_ups": 0, "autoscale_downs": 0,
                            "autoscale_blocked": 0, "pool_publishes": 0}
    with urllib.request.urlopen(client.admin_url + "/", timeout=30) as r:
        assert b"<html" in r.read()[:400].lower()


def test_clients_cross_over(app, tmp_path):
    """The JAX ``Client`` drives the port admin, and the port ``Client``
    a JAX admin, through the same calls."""
    client, *_ = app
    jc = JClient(client.admin_url)
    jc.login("superadmin@rafiki", "rafiki")
    m = jc.create_model_raw("toy", "IMAGE_CLASSIFICATION", "StackToy",
                            (tmp_path / "toy.py").read_bytes())
    assert [x["id"] for x in client.get_models()] == [m["id"]]
    assert jc.create_dataset("d", "IMAGE_CLASSIFICATION", "u")["uri"] == "u"

    jmeta = JMetaStore(str(tmp_path / "jmeta.db"))
    jm = JManager(jmeta, str(tmp_path / "jstack"), platform="cpu",
                  devices=[JDeviceSpec(id=0)])
    japp = JAdminApp(JAdmin(jmeta, jm))
    host, port = japp.start()
    try:
        pc = Client(f"http://{host}:{port}")
        assert pc.login("superadmin@rafiki", "rafiki")["user_type"] == \
            "SUPERADMIN"
        ds = pc.create_dataset("d", "IMAGE_CLASSIFICATION", "u")
        assert jmeta.get_dataset(ds["id"])["uri"] == "u"
        assert pc.create_user("a@b", "pw")["user_type"] == "APP_DEVELOPER"
    finally:
        japp.stop()


def test_a_toy_job_through_the_stack_in_subprocesses(app):
    """The spawn path on a CPU stack: advisor + train worker, the
    monitor's finalization (slot released, advisor stopped), then an
    inference worker + predictor over the port's kvd, predictions over
    HTTP through the port ``Client``, and a clean stop."""
    client, meta, manager, tmp_path = app
    manager.start_data_plane()
    m = _toy_model(client, tmp_path)
    ds = client.create_dataset("tr", "IMAGE_CLASSIFICATION", "unused")
    job = client.create_train_job(
        "toy-app", "IMAGE_CLASSIFICATION", ds["id"], ds["id"],
        budget={"TRIAL_COUNT": 3}, model_ids=[m["id"]],
        train_args={"advisor": "random"})
    assert job["status"] == "RUNNING"
    rows = {r["service_type"]: r for r in meta.get_services("RUNNING")}
    worker_cfg = rows["TRAIN_WORKER"]["spawn_spec"]["config"]
    assert worker_cfg["device"] == "cpu"
    assert worker_cfg["obs_port_file"] == str(
        manager.workdir / f"{worker_cfg['worker_id']}.obs_port")
    assert rows["TRAIN_WORKER"]["spawn_spec"]["module"] == \
        "rafiki_tpu_torch.worker.train"
    assert manager.allocator.free_count() == 0
    # the app's monitor is not running here: drive the manager's own wait
    assert manager.wait_train_job(job["id"], timeout=300)
    assert manager.allocator.free_count() == 1
    # a worker that exits takes its obs port file with it
    assert not Path(worker_cfg["obs_port_file"]).exists()
    trials = client.get_trials_of_train_job(job["id"])
    assert [t["status"] for t in trials] == ["COMPLETED"] * 3
    best = client.get_best_trials_of_train_job(job["id"], 1)[0]
    ij = client.create_inference_job(job["id"], max_workers=1)
    assert ij["status"] == "RUNNING" and manager.allocator.free_count() == 0
    preds = client.predict(ij["predictor_url"], [[1.0, 2.0], [3.0]])
    assert preds == [[best["score"], 3.0], [best["score"], 3.0]]
    types = sorted(s.service_type for s in manager.services.values())
    assert types == ["INFERENCE_WORKER", "PREDICTOR"]
    # the inference worker's sidecar, found through its obs_port_file
    iw = next(r for r in meta.get_services("RUNNING")
              if r["service_type"] == "INFERENCE_WORKER")
    obs_port = int(Path(iw["spawn_spec"]["config"][
        "obs_port_file"]).read_text())
    assert json_request("GET", f"http://127.0.0.1:{obs_port}/health") == \
        {"ok": True}
    pids = [s.proc.pid for s in manager.services.values()]
    client.stop_inference_job(ij["id"])
    assert not manager.services and manager.allocator.free_count() == 1
    assert all(not Path(f"/proc/{p}").exists() or
               Path(f"/proc/{p}/stat").read_text().split()[2] == "Z"
               for p in pids)


# ---- the advisor service

def _advisor_rounds(make, result_cls, client_cls, service_cls, knob_mod,
                    config_json, seed):
    svc = service_cls(make(knob_mod.knob_config_from_json(config_json),
                           "bohb", total_trials=9, seed=seed))
    host, port = svc.start()
    try:
        c = client_cls(f"http://{host}:{port}")
        out = []
        rng = np.random.default_rng(seed)
        for _ in range(9):
            p = c.propose()
            out.append(p.to_json())
            if p.trial_no % 4 == 3:
                c.trial_errored(p.trial_no)
            else:
                c.feedback(result_cls(trial_no=p.trial_no, knobs=p.knobs,
                                      score=float(rng.random()),
                                      budget_scale=p.budget_scale))
        out.append([x.to_json() for x in c.propose_batch(2)])
        st = c.status()
        out.append({k: st[k] for k in ("finished", "n_results")})
        return out
    finally:
        svc.stop()


def test_advisor_service_proposes_what_the_jax_one_proposes():
    config = pknob.knob_config_to_json(ViTBase16.get_knob_config())
    got = _advisor_rounds(make_advisor, TrialResult, AdvisorClient,
                          AdvisorService, pknob, config, seed=0)
    want = _advisor_rounds(jmake_advisor, JTrialResult, JAdvisorClient,
                           JAdvisorService, jknob, config, seed=0)
    assert got == want and len(got) == 11


def test_advisor_service_main_writes_its_port(tmp_path):
    cfg = tmp_path / "adv.json"
    cfg.write_text(json.dumps({
        "knob_config": pknob.knob_config_to_json(
            ViTBase16.get_knob_config()),
        "advisor_type": "random", "total_trials": 2,
        "port_file": str(tmp_path / "adv.port")}))
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "rafiki_tpu_torch.advisor.service",
         "--config", str(cfg)], env=env, stdout=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 120
        port_file = tmp_path / "adv.port"
        while not (port_file.exists() and port_file.read_text()):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        c = JAdvisorClient(f"http://127.0.0.1:{port_file.read_text()}")
        assert c.propose().trial_no == 0
        assert c.status()["n_results"] == 0
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# ---- model-class transport

def test_serialize_model_class_round_trips():
    blob = serialize_model_class(ViTBase16)
    assert blob == Path(sys.modules[ViTBase16.__module__].__file__
                        ).read_bytes()
    # the same bytes the JAX helper captures for the same class
    assert blob == jserialize(ViTBase16)
    cls = load_model_class(blob, "ViTBase16")
    assert cls is not ViTBase16 and cls.__name__ == "ViTBase16"
    assert pknob.knob_config_to_json(cls.get_knob_config()) == \
        pknob.knob_config_to_json(ViTBase16.get_knob_config())
    assert load_model_class(blob, "ViTBase16") is cls  # cached by digest
    with pytest.raises(ValueError, match="not a model template"):
        load_model_class(blob, "ViT")
