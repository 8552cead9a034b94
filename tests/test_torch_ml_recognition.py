"""The port's k-predictor (``models/ml_recognition.py``) against the JAX
package's: the numpy forward pass equal on the same coefs (1e-12, f64);
JSON written by either package read by the other; ``build_statistics`` and
``predict_k`` giving JAX's answers on the same per-k results (results.h5 as
JAX's tests write it, and the port's results.npz); the torch ``train_mlp``
learning separable blobs to the accuracy that tests/test_ml_recognition.py
asks of JAX's (> 0.95); and ``train_k_predictor`` end to end."""
import os

import numpy as np
import pytest
import torch

from pydnmfk_tpu.models import ml_recognition as jml
from pydnmfk_tpu_torch.models import ml_recognition as ml
from _parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


def _model(rng, sizes=(21, 30, 20, 7), activation="relu",
           out_activation="softmax", classes=None):
    coefs = [rng.normal(size=(a, b)) for a, b in zip(sizes, sizes[1:])]
    intercepts = [rng.normal(size=b) for b in sizes[1:]]
    return coefs, intercepts, activation, out_activation, classes


@pytest.mark.parametrize("activation", ["relu", "tanh", "logistic",
                                        "identity"])
@pytest.mark.parametrize("out_activation", ["softmax", "logistic", "identity"])
def test_forward_equals_jax(activation, out_activation):
    rng = np.random.default_rng(0)
    args = _model(rng, activation=activation, out_activation=out_activation,
                  classes=np.array([1, 3, 4, 6, 7, 8, 9]))
    X = rng.random((32, 21))
    ours, theirs = ml.MLPModel(*args), jml.MLPModel(*args)
    np.testing.assert_allclose(ours.predict_proba(X), theirs.predict_proba(X),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ours.predict(X), theirs.predict(X))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_json_crosses_between_the_packages(tmp_path, writer):
    rng = np.random.default_rng(1)
    args = _model(rng, sizes=(5, 8, 3), classes=np.array([0, 1, 2]))
    src, dst = (ml, jml) if writer == "port" else (jml, ml)
    path = str(tmp_path / "mlp.json")
    src.MLPModel(*args).to_json(path)
    back = dst.MLPModel.from_json(path)
    X = rng.normal(size=(6, 5))
    np.testing.assert_allclose(back.predict_proba(X),
                               src.MLPModel(*args).predict_proba(X),
                               rtol=1e-12)
    # the files both packages write are the same JSON
    other = str(tmp_path / "other.json")
    dst.MLPModel(*args).to_json(other)
    with open(path) as f, open(other) as g:
        assert f.read() == g.read()


def test_from_sklearn_equals_jax():
    from sklearn.neural_network import MLPClassifier
    import warnings
    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 5))
    y = rng.integers(0, 3, size=60)
    clf = MLPClassifier(hidden_layer_sizes=(8,), max_iter=50, random_state=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        clf.fit(X, y)
    np.testing.assert_allclose(ml.MLPModel.from_sklearn(clf).predict_proba(X),
                               clf.predict_proba(X), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(ml.MLPModel.from_sklearn(clf).predict(X),
                                  jml.MLPModel.from_sklearn(clf).predict(X))


def _write_results(path, ks, true_k, fmt="h5"):
    """tests/test_ml_recognition.py::_write_results: silhouettes collapse
    past true_k; "npz" writes results.npz with the same names, as the
    port's DataWriter does where h5py is absent."""
    for k in ks:
        d = os.path.join(str(path), str(k))
        os.makedirs(d, exist_ok=True)
        sils = np.ones(k) if k <= true_k else np.concatenate(
            [np.ones(true_k), 0.2 * np.ones(k - true_k)])
        err = 1.0 / min(k, true_k) + (0.001 * k)
        stats = {"clusterSilhouetteCoefficients": sils,
                 "avgSilhouetteCoefficients": sils.mean(),
                 "L_err": np.full(10, err), "L_errDist": err, "avgErr": err,
                 "recon_err": np.full(4, err), "AIC": -1000.0 / min(k, true_k)}
        if fmt == "npz":
            np.savez(os.path.join(d, "results.npz"),
                     ErrTol=stats.pop("recon_err"), **stats)
            continue
        import h5py
        with h5py.File(os.path.join(d, "results.h5"), "w") as f:
            f.create_dataset("ErrTol", data=stats.pop("recon_err"))
            for name, val in stats.items():
                f.create_dataset(name, data=val)


def _window_model(seed=2):
    rng = np.random.default_rng(seed)
    return _model(rng, sizes=(21, 16, 7))


@pytest.mark.parametrize("true_k", [3, 5, 8])
def test_build_statistics_and_predict_k_equal_jax(tmp_path, true_k):
    _write_results(tmp_path, range(1, 15), true_k)
    args = _window_model()
    ours = ml.MLFeatureTools(str(tmp_path), ml.MLPModel(*args))
    theirs = jml.MLFeatureTools(str(tmp_path), jml.MLPModel(*args))
    a, b = ours.build_statistics(), theirs.build_statistics()
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert ours.predict_statistics() == theirs.predict_statistics()
    path = str(tmp_path / "m.json")
    jml.MLPModel(*args).to_json(path)
    assert ml.predict_k(str(tmp_path), path) == jml.predict_k(str(tmp_path),
                                                              path)


def test_statistics_read_from_results_npz(tmp_path):
    """Where the writer had no h5py (the card's machine), each k's results
    are an npz with the same names; the statistics are the same."""
    _write_results(tmp_path / "h5", range(1, 12), 4)
    _write_results(tmp_path / "npz", range(1, 12), 4, fmt="npz")
    a = ml.MLFeatureTools(str(tmp_path / "npz"), None).build_statistics()
    b = jml.MLFeatureTools(str(tmp_path / "h5"), None).build_statistics()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_too_few_ks_raises(tmp_path):
    _write_results(tmp_path, range(1, 6), 3)
    with pytest.raises(ValueError, match="need more than"):
        ml.MLFeatureTools(str(tmp_path), ml.MLPModel(
            *_window_model())).predict_statistics()


def test_training_windows_equal_jax(tmp_path):
    apps = []
    for i, kt in enumerate([3, 6]):
        _write_results(tmp_path / str(i), range(2, 21, 2) if i else
                       range(1, 14), kt)
        apps.append(jml.MLFeatureTools(str(tmp_path / str(i)),
                                       None).build_statistics())
    Xa, ya = ml.build_training_windows(apps, [3, 6])
    Xb, yb = jml.build_training_windows(apps, [3, 6])
    np.testing.assert_array_equal(Xa, Xb)
    np.testing.assert_array_equal(ya, yb)


def test_train_mlp_learns_and_roundtrips(tmp_path):
    """tests/test_ml_recognition.py::test_train_mlp_learns_and_roundtrips
    with the port's trainer: three blobs, non-contiguous labels."""
    rng = np.random.default_rng(3)
    n_per = 60
    X = np.concatenate([rng.normal(loc=4.0 * i, scale=0.5, size=(n_per, 6))
                        for i in range(3)])
    y = np.repeat([2, 5, 9], n_per)
    model, net = ml.train_mlp(X, y, hidden=(16,), epochs=120, batch_size=16,
                              seed=1, device="cpu", return_module=True)
    assert np.mean(model.predict(X) == y) > 0.95
    assert model.classes.tolist() == [2, 5, 9]
    with torch.no_grad():
        logits = net(torch.from_numpy(X.astype(np.float32))).double().numpy()
    np.testing.assert_allclose(model.logits(X.astype(np.float32)), logits,
                               rtol=1e-5, atol=1e-5)
    path = str(tmp_path / "trained.json")
    model.to_json(path)
    back = jml.MLPModel.from_json(path)
    np.testing.assert_array_equal(back.predict(X), model.predict(X))
    # the same seed trains the same model
    again = ml.train_mlp(X, y, hidden=(16,), epochs=120, batch_size=16,
                         seed=1, device="cpu")
    for a, b in zip(again.coefs, model.coefs):
        np.testing.assert_array_equal(a, b)


def test_glorot_init_and_l2_term():
    """The init draws U(-b, b), b = sqrt(6 / (fan_in + fan_out)), zero
    biases; zero epochs return it."""
    X = np.random.default_rng(0).random((10, 4))
    model = ml.train_mlp(X, np.arange(10) % 2, hidden=(50,), epochs=0,
                         device="cpu")
    for W, b in zip(model.coefs, model.intercepts):
        bound = np.sqrt(6.0 / sum(W.shape))
        assert np.abs(W).max() <= bound and np.abs(W).max() > 0.8 * bound
        assert not b.any()


def test_train_mlp_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ml.train_mlp(np.ones((4, 2)), [0, 1, 0, 1], epochs=1)


def test_train_k_predictor_end_to_end(tmp_path):
    """tests/test_ml_recognition.py::test_train_k_predictor_end_to_end with
    the port's trainer: the vote finds the planted k of a held-out sweep."""
    train_dirs, true_ks = [], []
    for i, kt in enumerate([3, 4, 5, 6, 7, 8]):
        d = tmp_path / f"sweep{i}"
        _write_results(d, range(1, 15), kt)
        train_dirs.append(str(d))
        true_ks.append(kt)
    model = ml.train_k_predictor(train_dirs, true_ks, hidden=(32,),
                                 epochs=200, batch_size=8, seed=0,
                                 device="cpu")
    held = tmp_path / "held"
    _write_results(held, range(1, 15), 5)
    assert ml.MLFeatureTools(str(held), model).predict_statistics() == 5
    path = str(tmp_path / "k.json")
    model.to_json(path)
    assert jml.predict_k(str(held), path) == 5
