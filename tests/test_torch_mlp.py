"""Port parity: the feed-forward template (``rafiki_tpu_torch.models.mlp``,
BASELINE config #1), its tuning job, the zoo registry, the port's CLI and
``stack`` against the JAX package.

The data is the FashionMNIST-layout archive (28×28 greyscale PNGs in a
zip with a ``labels.csv``), written by the port's generator and read by
both packages' loaders.

Tolerances: per-epoch losses at rtol 1e-4 and trained leaves within 1e-4
(Adam from one init blob; the two frameworks sum the matmuls in another
order and Adam's step is ±lr wherever a gradient is at noise level, so
leaves are also held to lr per step); probabilities within 1e-5;
evaluate scores within 1e-6; served predictions equal ``predict``.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rafiki_tpu.advisor as JA
import rafiki_tpu_torch.advisor as PA
from rafiki_tpu.model import TrainContext as JTrainContext
from rafiki_tpu.models import _ZOO as JAX_ZOO
from rafiki_tpu.models.mlp import JaxFeedForward as JFeedForward
from rafiki_tpu.models.mlp import _MLP as JMLP
from rafiki_tpu.store.meta_store import MetaStore as JMetaStore
from rafiki_tpu.store.param_store import ParamStore as JParamStore
from rafiki_tpu.worker import train as jtrain
from rafiki_tpu_torch import cli
from rafiki_tpu_torch.data.dataset import generate_fashion_archive
from rafiki_tpu_torch.model import optim
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.model.dev import tune_model
from rafiki_tpu_torch.models import (NOT_PORTED, get_model_template,
                                     list_model_templates)
from rafiki_tpu_torch.models.mlp import JaxFeedForward
from rafiki_tpu_torch.serving import queues
from rafiki_tpu_torch.serving.decode_engine import NotPorted
from rafiki_tpu_torch.store.meta_store import MetaStore
from rafiki_tpu_torch.store.param_store import ParamStore
from rafiki_tpu_torch.worker import train as ptrain
from rafiki_tpu_torch.worker.inference import InferenceWorker

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
KNOBS = {"max_epochs": 3, "hidden_layer_count": 2, "hidden_layer_units": 32,
         "learning_rate": 3e-3, "batch_size": 32, "quick_train": False,
         "share_params": False}
PINS = {k: KNOBS[k] for k in ("hidden_layer_count", "hidden_layer_units",
                              "batch_size")}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("fashion")
    tr, va = str(d / "train.zip"), str(d / "val.zip")
    generate_fashion_archive(tr, 96, seed=0)
    val = generate_fashion_archive(va, 32, seed=1)
    module = JMLP(hidden_layer_count=2, hidden_layer_units=32, n_classes=10)
    params = module.init(jax.random.PRNGKey(3), jnp.zeros((1, 28, 28, 1)))
    blob = {"params": jax.tree_util.tree_map(np.asarray, params["params"]),
            "meta": {"n_classes": 10, "image_shape": [28, 28, 1]}}
    return dict(dir=d, train=tr, val=va, blob=blob, images=val.images,
                labels=val.labels)


@pytest.fixture(scope="module")
def trained(data):
    jm, pm = JFeedForward(**KNOBS), JaxFeedForward(device="cpu", **KNOBS)
    jctx, pctx = JTrainContext(), TrainContext()
    jm.load_parameters(data["blob"])
    pm.load_parameters(data["blob"])
    jm.train(data["train"], jctx)
    pm.train(data["train"], pctx)
    return dict(jm=jm, pm=pm, jctx=jctx, pctx=pctx)


def test_feed_forward_losses_leaves_and_predictions_match_jax(trained,
                                                               data):
    jm, pm = trained["jm"], trained["pm"]
    want = trained["jctx"].logger.get_values("loss")
    got = trained["pctx"].logger.get_values("loss")
    assert len(got) == len(want) == KNOBS["max_epochs"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    jd, pd = jm.dump_parameters(), pm.dump_parameters()
    assert pd["meta"] == jd["meta"] == data["blob"]["meta"]
    w, g = _flat(jd["params"]), _flat(pd["params"])
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=1e-4, err_msg=k)
    assert pm.evaluate(data["val"]) == pytest.approx(
        jm.evaluate(data["val"]), abs=1e-6)
    queries = [data["images"][i, :, :, 0] for i in range(5)]  # 2-D, as PIL
    np.testing.assert_allclose(np.asarray(pm.predict(queries)),
                               np.asarray(jm.predict(queries)), atol=1e-5)


def test_adam_matches_optax_scale_by_adam():
    """``optim.lane_adam_step`` against ``scale_by_adam()`` then ``−lr``,
    the template's update, over 6 steps (rtol 1e-5 with a floor of
    1e-6); and, as the LoRA lanes run it, with ``add_decayed_weights``
    before ``−lr``, over two lanes at two rates (a (2,) ``lr``)."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((2, 4, 3)).astype(np.float32)
    lrs = np.asarray([1e-2, 3e-3], np.float32)
    for wd in (0.0, 1e-4):
        tx = optax.chain(optax.scale_by_adam(),
                         optax.add_decayed_weights(wd))
        jp = [jnp.asarray(p0[i]) for i in range(2)]
        states = [tx.init(p) for p in jp]
        tp = {"w": torch.from_numpy(p0.copy())}
        opt = optim.lane_adam_init(tp, (2,))
        for step in range(6):
            g = rng.standard_normal(p0.shape).astype(np.float32)
            for i in range(2):
                u, states[i] = tx.update(jnp.asarray(g[i]), states[i],
                                         jp[i])
                jp[i] = jp[i] - lrs[i] * u
            optim.lane_adam_step(tp, {"w": torch.from_numpy(g)}, opt,
                                 torch.from_numpy(lrs), wd)
            np.testing.assert_allclose(tp["w"].numpy(),
                                       np.stack([np.asarray(p) for p in jp]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{wd} {step}")


def test_gang_size_is_refused_by_name(data):
    """Once a refusal (the port had no gang engine); now ``gang_size=1``
    runs the gang engine, and its one lane scores exactly as the
    sequential trial on the FashionMNIST-layout archive."""
    kw = dict(total_trials=2, advisor_type="random", seed=4,
              knob_overrides=PINS, device="cpu")
    seq = tune_model(JaxFeedForward, data["train"], data["val"], **kw)
    gang = tune_model(JaxFeedForward, data["train"], data["val"],
                      gang_size=1, **kw)
    assert [t.knobs for t in gang.trials] == [t.knobs for t in seq.trials]
    assert [t.score for t in gang.trials] == [t.score for t in seq.trials]


# ---- a tuning job through both train workers, served by the port's

def _from_init(base, blob):
    class FromInit(base):
        def train(self, dataset_path, ctx=None):
            if self._params is None:
                self.load_parameters(blob)
            return super().train(dataset_path, ctx)

    FromInit.__name__ = base.__name__
    return FromInit


@pytest.fixture(scope="module")
def jobs(data):
    out = {}
    for name in ("jax", "port"):
        mods = ((JMetaStore, JParamStore, jtrain, JA, JFeedForward)
                if name == "jax" else
                (MetaStore, ParamStore, ptrain, PA, JaxFeedForward))
        meta_cls, store_cls, worker_mod, adv, template = mods
        root = data["dir"] / name
        root.mkdir()
        meta = meta_cls(str(root / "meta.db"))
        job = meta.create_train_job("u0", "ff", 1, "IMAGE_CLASSIFICATION",
                                    {"TRIAL_COUNT": 2}, "tr", "va")
        sub = meta.create_sub_train_job(job["id"], "m0")["id"]
        store = store_cls.from_uri(f"file://{root / 'params'}")
        kw = {"device": "cpu"} if name == "port" else {}
        worker = worker_mod.TrainWorker(
            _from_init(template, data["blob"]),
            adv.make_advisor(template.get_knob_config(), "random",
                             total_trials=2, seed=0),
            data["train"], data["val"], param_store=store, meta_store=meta,
            sub_train_job_id=sub, model_id="m0", worker_id="w0",
            knob_overrides=PINS, **kw)
        assert worker.run() == 2
        out[name] = {"meta": meta, "store": store, "sub": sub,
                     "job": job["id"]}
    return out


def test_tuning_job_matches_jax_and_its_winner_serves(jobs, data):
    j, p = jobs["jax"], jobs["port"]
    jt = j["meta"].get_trials_of_sub_train_job(j["sub"])
    pt = p["meta"].get_trials_of_sub_train_job(p["sub"])
    assert [(t["trial_no"], t["knobs"], t["status"]) for t in pt] == \
        [(t["trial_no"], t["knobs"], t["status"]) for t in jt]
    assert [t["status"] for t in pt] == ["COMPLETED"] * 2
    for a, b in zip(pt, jt):
        assert a["score"] == pytest.approx(b["score"], abs=1e-6)
    best = p["meta"].get_best_trials_of_train_job(p["job"], 1)[0]
    hub = queues.InProcQueueHub()
    worker = InferenceWorker(JaxFeedForward, best["id"], best["knobs"],
                             p["store"], hub, "f0", device="cpu")
    images = data["images"]
    msgs = [{"id": f"m{i}", "queries": images[8 * i:8 * (i + 1)]}
            for i in range(4)]
    for m in msgs:
        hub.push_query("f0", queues.pack_message(m))
    loop = threading.Thread(target=worker.run,
                            kwargs={"poll_timeout": 0.01})
    loop.start()
    try:
        replies = [queues.unpack_message(hub.pop_prediction(m["id"], 60.0))
                   for m in msgs]
    finally:
        worker.stop()
        loop.join(timeout=30)
    assert not loop.is_alive()
    got = np.concatenate([np.asarray(r["predictions"], np.float32)
                          for r in replies])
    direct = JaxFeedForward(device="cpu", **best["knobs"])
    direct.load_parameters(p["store"].load(best["id"]))
    np.testing.assert_array_equal(
        got, np.asarray(direct.predict(list(images)), np.float32))
    acc = float(np.mean(np.argmax(got, -1) == data["labels"]))
    assert acc == pytest.approx(best["score"], abs=1e-6)


# ---- the zoo registry and the CLI

def test_zoo_has_jax_names_and_refuses_the_unported_by_name():
    assert set(list_model_templates()) == set(JAX_ZOO)
    for name in NOT_PORTED:
        assert list_model_templates()[name] == "not ported"
        with pytest.raises(NotPorted, match=name):
            get_model_template(name)
    for name in ("JaxFeedForward", "ResNetClassifier", "VGGClassifier",
                 "DenseNetClassifier", "ViTBase16", "BertClassifier",
                 "LlamaLoRA"):
        cls = get_model_template(name)
        assert cls.__name__ == name
        assert cls.__module__.startswith("rafiki_tpu_torch.models.")
    with pytest.raises(KeyError, match=r"unknown template 'Nope'; known: "
                                       r"\['BertClassifier'"):
        get_model_template("Nope")


def test_cli_version_and_refusals(capsys):
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.strip() == \
        __import__("rafiki_tpu_torch").__version__
    with pytest.raises(NotPorted, match="'lint'"):
        cli.main(["lint"])
    # doctor and backup are served: here the doctor finds no card, and
    # the backup no stack
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        assert cli.main(["doctor"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] cuda device" in out and "SOME CHECKS FAILED" in out
    assert "[ok ] native kv server" in out
    assert cli.main(["backup", "out.db", "--workdir", "no-such-stack"]) == 1
    assert "no MetaStore at no-such-stack/meta.db" in \
        capsys.readouterr().err
    with pytest.raises(KeyError, match="known"):
        cli.main(["tune", "Nope", "a", "b", "--device", "cpu"])
    with pytest.raises(NotPorted, match="BigramHMM"):
        cli.main(["tune", "BigramHMM", "a", "b", "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        cli.main(["no-such-command"])
    assert e.value.code == 2


def test_cli_tune_on_the_cpu_in_a_subprocess(data):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "rafiki_tpu_torch.cli", "tune",
         "JaxFeedForward", data["train"], data["val"], "--trials", "2",
         "--advisor", "random", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    line = r.stdout.strip().splitlines()[-1]
    assert line.startswith("best_score=")
    assert 0.0 <= float(line.split()[0].split("=")[1]) <= 1.0
    # without --device the trials go to the card, and without one it raises
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["tune", "JaxFeedForward", data["train"], data["val"],
                      "--trials", "1"])


def test_stack_start_status_stop_on_the_cpu(tmp_path, capsys):
    workdir = str(tmp_path / "stack")
    base = ["stack", "--workdir", workdir, "--port", "0"]
    assert cli.main(["stack", "status", "--workdir", workdir]) == 1
    try:
        assert cli.main(["stack", "start", "--workdir", workdir, "--port",
                         "0", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "stack up: http://127.0.0.1:" in out
        cfg = json.loads((tmp_path / "stack" / "admin.json").read_text())
        assert cfg["platform"] == "cpu" and "cpu_slots" not in cfg
        pid = int((tmp_path / "stack" / "admin.pid").read_text())
        assert cli.main(["stack", "start", "--workdir", workdir,
                         "--device", "cpu"]) == 1  # already running
        assert cli.main(["stack", "status", "--workdir", workdir]) == 0
        health = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert health["url"].startswith("http://127.0.0.1:")
    finally:
        assert cli.main([*base[:1], "stop", *base[1:3]]) == 0
    assert "stack stopped" in capsys.readouterr().out
    assert not Path(f"/proc/{pid}").exists() or \
        Path(f"/proc/{pid}/stat").read_text().split(")")[-1].split()[0] == "Z"
    # --cold is served: the admin reaps what a previous one left
    try:
        assert cli.main(["stack", "start", "--workdir", workdir, "--port",
                         "0", "--device", "cpu", "--cold"]) == 0
        cfg = json.loads((tmp_path / "stack" / "admin.json").read_text())
        assert cfg["cold_start"] is True
    finally:
        assert cli.main(["stack", "stop", "--workdir", workdir]) == 0
    assert "cold start: reaped 0 stale service row(s)" in \
        (tmp_path / "stack" / "admin.log").read_text()
