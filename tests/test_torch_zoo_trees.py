"""The port's scikit-learn-free tabular templates against the JAX
package's, which fit with scikit-learn 1.9.0, on the CPU.

- ``SklearnDecisionTree`` at seven knob points (depth 3/8/16, Gini and
  entropy, ``min_samples_split`` 2 and 16, ``min_impurity_decrease``
  1e-6 and 1e-2): the exported child, feature and threshold arrays equal
  JAX's, ``dist`` within 1e-7; ``_tree_fit.fit_tree`` equals sklearn's
  ``tree_`` node for node, impurities included;
- ``SklearnGBDT`` at ``subsample`` 1.0 and 0.8, two and three classes:
  the port's blob, loaded into the JAX template, gives probabilities
  within 1e-5 of JAX's own fit (the bound JAX's test holds against
  sklearn); every tree equals sklearn's;
- ``SklearnSVM``, linear and rbf: libsvm's iterations, support vectors
  and coefficients, and decision values within 1e-4 of JAX's, equal
  predictions; for two classes the port votes as sklearn predicts, where
  JAX's vote is inverted (``ROADMAP.md`` Queue C 21);
- blobs of all three cross both ways through both codecs.
"""

import numpy as np
import pytest
from sklearn.ensemble import GradientBoostingClassifier
from sklearn.svm import SVC
from sklearn.tree import DecisionTreeClassifier

from rafiki_tpu.data import generate_tabular_dataset as jgen_table
from rafiki_tpu.data import load_tabular_dataset as jload_table
from rafiki_tpu.models import sklearn_models as jsk
from rafiki_tpu.store.param_store import params_from_bytes as jax_from_bytes
from rafiki_tpu.store.param_store import params_to_bytes as jax_to_bytes
from rafiki_tpu_torch.model.base import TrainContext
from rafiki_tpu_torch.models import sklearn_models as psk
from rafiki_tpu_torch.models._svm_fit import fit_svc
from rafiki_tpu_torch.models._tree_fit import fit_gbdt, fit_tree
from rafiki_tpu_torch.store.param_store import (params_from_bytes,
                                               params_to_bytes)

DT_POINTS = [(3, "gini", 2, 1e-6), (8, "gini", 16, 1e-6),
             (16, "gini", 2, 1e-6), (8, "entropy", 2, 1e-6),
             (16, "entropy", 16, 1e-2), (8, "gini", 2, 1e-2),
             (16, "entropy", 2, 1e-6)]
GBDT_KNOBS = {"n_estimators": 12, "learning_rate_gb": 0.2, "max_depth": 3}
SVM_KNOBS = {"C": 1.0, "gamma_scale": 1.0}


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """{n_classes: (train, val)}: the JAX test's 3-class table, and a
    2-class one."""
    d = tmp_path_factory.mktemp("zoo_trees")
    out = {}
    for k, n in ((3, 512), (2, 320)):
        tr, va = str(d / f"tr{k}.npz"), str(d / f"va{k}.npz")
        jgen_table(tr, n, n_classes=k, seed=0)
        jgen_table(va, 128, n_classes=k, seed=1)
        out[k] = (tr, va)
    return out


def _dt_knobs(depth, crit, mss, mid):
    return {"max_depth": depth, "criterion": crit,
            "min_samples_split": mss, "min_impurity_decrease": mid}


# ---- the decision tree

@pytest.mark.parametrize("point", DT_POINTS,
                         ids=["-".join(map(str, p)) for p in DT_POINTS])
def test_decision_tree_arrays_equal_jax(tables, point):
    tr, va = tables[3]
    knobs = _dt_knobs(*point)
    jm, pm = jsk.SklearnDecisionTree(**knobs), \
        psk.SklearnDecisionTree(device="cpu", **knobs)
    jm.train(tr)
    ctx = TrainContext()
    pm.train(tr, ctx)
    jb, pb = jm.dump_parameters(), pm.dump_parameters()
    assert set(jb) == set(pb)
    for k in ("children_left", "children_right", "feature", "threshold"):
        assert pb[k].dtype == jb[k].dtype
        np.testing.assert_array_equal(pb[k], jb[k])
    assert pb["dist"].dtype == np.float32
    np.testing.assert_allclose(pb["dist"], jb["dist"], atol=1e-7)
    assert pb["meta"] == jb["meta"]
    q = list(jload_table(va).features)
    np.testing.assert_allclose(pm.predict(q), jm.predict(q), atol=1e-7)
    assert pm.evaluate(va) == jm.evaluate(va)
    assert 0.0 <= ctx.logger.get_values("loss")[0] < 0.5


@pytest.mark.parametrize("k", [2, 3])
def test_fit_tree_is_sklearns_node_for_node(tables, k):
    ds = jload_table(tables[k][0])
    for depth, crit, mss, mid in DT_POINTS[:4]:
        ref = DecisionTreeClassifier(
            max_depth=depth, criterion=crit, min_samples_split=mss,
            min_impurity_decrease=mid, random_state=0).fit(ds.features,
                                                           ds.labels)
        t = fit_tree(ds.features, ds.labels, max_depth=depth,
                     criterion=crit, min_samples_split=mss,
                     min_impurity_decrease=mid, n_classes=k)
        r = ref.tree_
        for a, b in ((t.children_left, r.children_left),
                     (t.children_right, r.children_right),
                     (t.feature, r.feature), (t.threshold, r.threshold),
                     (t.n_node_samples, r.n_node_samples),
                     (t.impurity, r.impurity)):
            np.testing.assert_array_equal(np.asarray(a), b)


# ---- gradient boosting

@pytest.mark.parametrize("k,subsample", [(2, 1.0), (2, 0.8), (3, 1.0),
                                         (3, 0.8)])
def test_gbdt_blob_in_jax_gives_jax_probabilities(tables, k, subsample):
    tr, va = tables[k]
    knobs = dict(GBDT_KNOBS, subsample=subsample)
    jm, pm = jsk.SklearnGBDT(**knobs), psk.SklearnGBDT(device="cpu",
                                                        **knobs)
    jm.train(tr)
    pm.train(tr)
    x = jload_table(va).features
    loaded = jsk.SklearnGBDT(**knobs)
    loaded.load_parameters(pm.dump_parameters())
    np.testing.assert_allclose(loaded._probs(x), jm._probs(x), atol=1e-5)
    np.testing.assert_allclose(pm._probs(x), jm._probs(x), atol=1e-5)
    jb, pb = jm.dump_parameters(), pm.dump_parameters()
    assert len(pb["trees"]) == len(jb["trees"]) == \
        GBDT_KNOBS["n_estimators"] * (1 if k == 2 else k)
    for a, b in zip(jb["trees"], pb["trees"]):
        for key in ("left", "right", "feature", "threshold"):
            np.testing.assert_array_equal(b[key], a[key])
        np.testing.assert_allclose(b["value"], a["value"], atol=1e-6)
    np.testing.assert_array_equal(pb["prior"], jb["prior"])
    assert (pb["k"], pb["n_stages"], pb["n_classes"]) == \
        (jb["k"], jb["n_stages"], jb["n_classes"])


def test_fit_gbdt_trees_are_sklearns(tables):
    ds = jload_table(tables[3][0])
    ref = GradientBoostingClassifier(n_estimators=6, learning_rate=0.3,
                                     max_depth=3, subsample=0.7,
                                     random_state=0).fit(ds.features,
                                                         ds.labels)
    fit = fit_gbdt(ds.features, ds.labels, n_estimators=6,
                   learning_rate=0.3, max_depth=3, subsample=0.7)
    for s, stage in enumerate(fit["trees"]):
        for c, t in enumerate(stage):
            r = ref.estimators_[s, c].tree_
            np.testing.assert_array_equal(t.feature, r.feature)
            np.testing.assert_array_equal(t.threshold, r.threshold)
            np.testing.assert_array_equal(t.value[:, 0], r.value[:, 0, 0])
    with pytest.raises(ValueError, match="at least 2 classes"):
        fit_gbdt(ds.features, np.zeros(len(ds.labels), np.int64),
                 n_estimators=2, learning_rate=0.1, max_depth=2,
                 subsample=1.0)


# ---- the SVM

@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_svm_is_libsvm_and_decides_as_jax(tables, kernel):
    tr, va = tables[3]
    knobs = dict(SVM_KNOBS, kernel=kernel)
    jm, pm = jsk.SklearnSVM(**knobs), psk.SklearnSVM(device="cpu", **knobs)
    jm.train(tr)
    pm.train(tr)
    # the solver: libsvm's iterations, support vectors and coefficients
    ds = jload_table(tr)
    mean, std = ds.features.mean(axis=0), ds.features.std(axis=0) + 1e-6
    x = (ds.features - mean) / std
    gamma = 1.0 / (x.shape[1] * max(x.var(), 1e-12))
    ref = SVC(C=1.0, kernel=kernel, gamma=gamma, random_state=0).fit(
        x, ds.labels)
    fit = fit_svc(x, ds.labels, c=1.0, kernel=kernel, gamma=gamma)
    np.testing.assert_array_equal(fit["n_iter_"], ref.n_iter_)
    np.testing.assert_array_equal(fit["support_"], ref.support_)
    np.testing.assert_allclose(fit["dual_coef_"], ref.dual_coef_,
                               atol=1e-9)
    np.testing.assert_allclose(fit["intercept_"], ref.intercept_,
                               atol=1e-9)
    # the template: JAX's decision values from its own blob
    xv = np.asarray(jload_table(va).features, np.float64)
    loaded = psk.SklearnSVM(**knobs)
    loaded.load_parameters(jm.dump_parameters())
    np.testing.assert_allclose(pm.decision_values(xv),
                               loaded.decision_values(xv), atol=1e-4)
    same = np.mean(np.argmax(pm._probs(xv), -1)
                   == np.argmax(jm._probs(xv), -1))
    assert same >= 0.99
    assert pm.evaluate(va) > 0.6


def test_two_class_svm_votes_as_sklearn_predicts(tables):
    tr, va = tables[2]
    knobs = dict(SVM_KNOBS, kernel="rbf")
    jm, pm = jsk.SklearnSVM(**knobs), psk.SklearnSVM(device="cpu", **knobs)
    jm.train(tr)
    pm.train(tr)
    ds, vds = jload_table(tr), jload_table(va)
    mean, std = ds.features.mean(axis=0), ds.features.std(axis=0) + 1e-6
    x = (ds.features - mean) / std
    ref = SVC(C=1.0, kernel="rbf", gamma=pm.dump_parameters()["meta"][
        "gamma"], random_state=0).fit(x, ds.labels)
    want = ref.predict((vds.features - mean) / std)
    xv = np.asarray(vds.features, np.float64)
    np.testing.assert_array_equal(pm.dump_parameters()["dual_coef"],
                                  jm.dump_parameters()["dual_coef"])
    assert np.mean(np.argmax(pm._probs(xv), -1) == want) >= 0.99
    # JAX's two-class vote reads sklearn's negated public sign
    assert np.mean(np.argmax(jm._probs(xv), -1) == want) <= 0.01
    assert pm.evaluate(va) > 0.8


# ---- blobs

TEMPLATES = [("dt", _dt_knobs(8, "entropy", 2, 1e-6)),
             ("gbdt", dict(GBDT_KNOBS, subsample=0.8)),
             ("svm", dict(SVM_KNOBS, kernel="rbf"))]
CLASSES = {"dt": "SklearnDecisionTree", "gbdt": "SklearnGBDT",
           "svm": "SklearnSVM"}


@pytest.mark.parametrize("name,knobs", TEMPLATES,
                         ids=[n for n, _ in TEMPLATES])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_blobs_cross_both_ways(tables, name, knobs, writer):
    tr, va = tables[3]
    jcls, pcls = getattr(jsk, CLASSES[name]), getattr(psk, CLASSES[name])
    src = pcls(**knobs) if writer == "port" else jcls(**knobs)
    src.train(tr)
    q = list(jload_table(va).features)
    want = np.asarray(src.predict(q))
    for dst in (jcls(**knobs), pcls(**knobs)):
        for encode, decode in ((params_to_bytes, jax_from_bytes),
                               (jax_to_bytes, params_from_bytes)):
            dst.load_parameters(decode(encode(src.dump_parameters())))
            np.testing.assert_allclose(np.asarray(dst.predict(q)), want,
                                       atol=1e-6)


@pytest.mark.parametrize("name", ["SklearnGBDT", "SklearnSVM"])
def test_a_host_job_trains_and_serves_through_the_workers(tables, tmp_path,
                                                          name):
    from test_torch_zoo_tabular import train_and_serve

    tr, va = tables[3]
    pins = ({"n_estimators": 10, "max_depth": 2} if name == "SklearnGBDT"
            else {"kernel": "rbf"})
    queries = jload_table(va).features[:24].tolist()
    served, direct = train_and_serve(
        tmp_path, getattr(psk, name), "TABULAR_CLASSIFICATION", tr, va,
        queries, pins)
    np.testing.assert_array_equal(np.asarray(served), np.asarray(direct))
