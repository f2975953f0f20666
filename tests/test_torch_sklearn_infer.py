"""The port's device acoustic heads (torch) against the JAX package's
device heads on the same converted dicts, and against sklearn at
``tests/test_sklearn_infer.py``'s own tolerances, on the CPU.

Against JAX: decision values and probabilities within 1e-5 abs (fp32 on
both sides, other summation orders); labels equal wherever every
|decision value| exceeds 1e-4. Against sklearn: the scaler within 1e-4,
SVC probabilities within 2e-4, the forest within 1e-5, labels equal."""

import numpy as np
import pytest
import torch
from sklearn.ensemble import RandomForestClassifier
from sklearn.preprocessing import StandardScaler
from sklearn.svm import SVC

from audio_processor_tpu.models import sklearn_infer as jsk
from audio_processor_tpu_torch.models import sklearn_infer as tsk
from tests.test_sklearn_infer import make_data

JAX_ATOL = 1e-5
TIE = 1e-4


@pytest.fixture(scope="module")
def test_x():
    return make_data(np.random.default_rng(7), n=64)[0].astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _clear(dec):
    """Rows whose every ovo decision value is away from 0."""
    return (np.abs(dec) > TIE).all(-1)


def _check_svc(svc, x):
    model = tsk.convert_svc(svc)
    jmodel = jsk.convert_svc(svc)
    dec = tsk.svc_decision_values(model, _t(x)).numpy()
    jdec = np.asarray(jsk.svc_decision_values(jmodel, x))
    np.testing.assert_allclose(dec, jdec, atol=JAX_ATOL)
    proba = tsk.svc_predict_proba(model, _t(x)).numpy()
    np.testing.assert_allclose(proba, np.asarray(
        jsk.svc_predict_proba(jmodel, x)), atol=JAX_ATOL)
    pred = tsk.svc_predict(model, _t(x)).numpy()
    clear = _clear(jdec)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(
        pred[clear], np.asarray(jsk.svc_predict(jmodel, x))[clear])
    # sklearn, at the JAX package's own tolerances.
    assert (model["classes"][pred] == svc.predict(x)).all()
    np.testing.assert_allclose(proba, svc.predict_proba(x), atol=2e-4)
    # The same from a dict whose weights were moved once.
    moved = tsk.to_device(model, "cpu")
    assert torch.is_tensor(moved["support_vectors"])
    np.testing.assert_array_equal(
        tsk.svc_predict_proba(moved, _t(x)).numpy(), proba)


def test_scaler_matches_jax_and_sklearn(test_x):
    x, _ = make_data(np.random.default_rng(42))
    sc = StandardScaler().fit(x)
    got = tsk.scaler_transform(tsk.convert_scaler(sc), _t(test_x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsk.scaler_transform(
        jsk.convert_scaler(sc), test_x)), atol=JAX_ATOL)
    np.testing.assert_allclose(got, sc.transform(test_x), atol=1e-4)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_rbf_svc_matches_jax_and_sklearn(k, test_x):
    """k = 2 checks that the binary sign flip of ``convert_svc`` is
    applied once."""
    x, y = make_data(np.random.default_rng(k), n=300, k=k)
    _check_svc(SVC(kernel="rbf", probability=True,
                   random_state=0).fit(x, y), test_x)


@pytest.mark.parametrize("kernel,kw", [
    ("linear", {}),
    ("poly", {"degree": 3, "coef0": 1.0, "gamma": "scale"}),
    ("sigmoid", {"coef0": 0.25, "gamma": "auto"}),
])
def test_svc_kernels_match_jax_and_sklearn(kernel, kw, test_x):
    x, y = make_data(np.random.default_rng(7), n=300, k=3)
    _check_svc(SVC(kernel=kernel, probability=True, random_state=0,
                   **kw).fit(x, y), test_x)


def test_svc_string_classes(test_x):
    x, y = make_data(np.random.default_rng(1), n=200, k=3)
    labels = np.array(["content", "mécontent", "neutre"])[y]
    svc = SVC(kernel="rbf", probability=True, random_state=0).fit(x, labels)
    model = tsk.convert_svc(svc)
    got = model["classes"][tsk.svc_predict(model, _t(test_x)).numpy()]
    assert (got == svc.predict(test_x)).all()
    jgot = model["classes"][np.asarray(jsk.svc_predict(
        jsk.convert_svc(svc), test_x))]
    assert (got == jgot).all()


def test_multiclass_coupling_matches_jax():
    """Rows that converge at different iterations (and some that do not
    before max_iter): the frozen rows keep their p, as the reference's
    ``while_loop`` does."""
    rng = np.random.default_rng(3)
    k, B = 5, 32
    r = np.full((B, k, k), 0.5, np.float32)
    for i in range(k):
        for j in range(i + 1, k):
            pij = rng.uniform(1e-3, 1 - 1e-3, B).astype(np.float32)
            r[:, i, j], r[:, j, i] = pij, 1 - pij
    for max_iter in (1, 3, 100):
        got = tsk._multiclass_coupling(_t(r), k, max_iter).numpy()
        want = np.asarray(jsk._multiclass_coupling(r, k, max_iter))
        np.testing.assert_allclose(got, want, atol=JAX_ATOL)


@pytest.mark.parametrize("n_estimators,max_depth", [(10, 4), (25, None)])
def test_forest_matches_jax_and_sklearn(n_estimators, max_depth, test_x):
    x, y = make_data(np.random.default_rng(42))
    rf = RandomForestClassifier(n_estimators=n_estimators,
                                max_depth=max_depth,
                                random_state=0).fit(x, y)
    model = tsk.convert_forest(rf)
    proba = tsk.forest_predict_proba(model, _t(test_x)).numpy()
    jproba = np.asarray(jsk.forest_predict_proba(jsk.convert_forest(rf),
                                                 test_x))
    np.testing.assert_allclose(proba, jproba, atol=JAX_ATOL)
    np.testing.assert_allclose(proba, rf.predict_proba(test_x), atol=1e-5)
    pred = tsk.forest_predict(model, _t(test_x)).numpy()
    np.testing.assert_array_equal(pred, np.asarray(
        jsk.forest_predict(jsk.convert_forest(rf), test_x)))
    assert (model["classes"][pred] == rf.predict(test_x)).all()
    moved = tsk.forest_predict_proba(tsk.to_device(model, "cpu"),
                                     _t(test_x)).numpy()
    np.testing.assert_array_equal(moved, proba)
