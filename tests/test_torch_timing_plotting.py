"""The port's ``utils/timing.py`` additions, ``ops/linalg.py::kl_divergence``
and ``utils/plotting.py`` against the JAX package's: ``category_breakdown``
equal on the same timings; ``kl_divergence`` within 1e-6 relative of JAX's
(f64; f32 sums at f32); the same plot file names from a sweep dir; and
``timing_stats`` parsing a CSV as JAX's does, including the port's own."""
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from _parity import one_thread, x64
import jax.numpy as jnp
from pydnmfk_tpu.ops import linalg as jlinalg
from pydnmfk_tpu.utils import plotting as jplotting
from pydnmfk_tpu.utils import timing as jtiming
import pydnmfk_tpu_torch as port
from pydnmfk_tpu_torch.ops import linalg
from pydnmfk_tpu_torch.utils import plotting, timing

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture
def timings():
    saved = dict(timing.TIMINGS), timing.ENABLED
    jsaved = dict(jtiming.TIMINGS), jtiming.ENABLED
    yield
    timing.TIMINGS.clear()
    timing.TIMINGS.update(saved[0])
    timing.enable(saved[1])
    jtiming.TIMINGS.clear()
    jtiming.TIMINGS.update(jsaved[0])
    jtiming.enable(jsaved[1])


def test_categories_are_the_jax_packages():
    assert timing.CATEGORIES == jtiming.CATEGORIES


def test_category_breakdown_equals_jax(timings):
    entries = {"read": 0.5, "solve": 2.0, "init_factors": 0.25,
               "cluster_ensemble": 0.125, "sample_ensemble": 0.0625,
               "dist_comm_est": 0.03125, "ensemble_solve": 1.5,
               "mystery": 0.1}
    timing.reset()
    jtiming.reset()
    timing.TIMINGS.update(entries)
    jtiming.TIMINGS.update(entries)
    assert timing.category_breakdown() == jtiming.category_breakdown()


def test_timed_fn_records_by_name_when_enabled(timings):
    @timing.timed_fn
    def step(x):
        return x + 1

    timing.reset()
    timing.enable(False)
    assert step(1) == 2 and "step" not in timing.TIMINGS
    timing.enable(True)
    assert step(2) == 3 and step(3) == 4
    assert timing.TIMINGS["step"] >= 0.0
    assert step.__name__ == "step"
    assert timing.category_breakdown()["other"] == timing.TIMINGS["step"]


def test_trace_writes_a_chrome_trace(tmp_path):
    with timing.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "tr" / "trace.json"
    assert path.exists() and "aten::" in path.read_text()
    with timing.trace(None):
        pass


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("chunk", [0, 7])
def test_kl_divergence_matches_jax(precision, chunk):
    rng = np.random.default_rng(5)
    A = rng.random((40, 30)) * (rng.random((40, 30)) > 0.2)
    W, H = rng.random((40, 4)), rng.random((4, 30))
    eps = float(np.finfo(precision).eps)
    with x64():
        want = float(jlinalg.kl_divergence(
            *(jnp.asarray(x, precision) for x in (A, W, H)), eps))
    dt = getattr(torch, precision)
    got = linalg.kl_divergence(*(torch.from_numpy(x).to(dt)
                                 for x in (A, W, H)), eps, chunk)
    assert got.dtype == dt
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_kl_divergence_of_a_stack_and_a_narrow_a():
    rng = np.random.default_rng(6)
    A = torch.from_numpy(rng.random((3, 20, 12)))
    W, H = torch.from_numpy(rng.random((3, 20, 2))), torch.from_numpy(
        rng.random((3, 2, 12)))
    out = linalg.kl_divergence(A, W, H, 1e-12)
    assert out.shape == (3,)
    for i in range(3):
        assert float(out[i]) == float(linalg.kl_divergence(A[i], W[i], H[i],
                                                           1e-12))
    # a bf16 A sums in f32, as the JAX package's does
    Ab = A[0].float().to(torch.bfloat16)
    with x64():
        want = float(jlinalg.kl_divergence(
            jnp.asarray(np.asarray(Ab.float()), jnp.bfloat16),
            jnp.asarray(W[0].numpy(), jnp.float32),
            jnp.asarray(H[0].numpy(), jnp.float32), 1e-7))
    got = linalg.kl_divergence(Ab, W[0].float(), H[0].float(), 1e-7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_sweep_writes_the_jax_plot_files(tmp_path):
    """A port sweep writes its selection plot; JAX's plotting, run on the
    port's sweep dir, writes the same file names."""
    from pydnmfk_tpu.utils.data_generator import generate_data
    _, _, X = generate_data(m=40, n=30, k=3, seed=100)
    cfg = port.NMFkConfig(nmf=port.NMFConfig(norm="fro", itr=50),
                          start_k=2, end_k=4, perturbations=4,
                          results_path=f"{tmp_path}/res/", fname="X",
                          checkpoint=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port.NMFk(cfg, "cpu").fit(X)
    ours = tmp_path / "res" / "X"
    theirs = tmp_path / "jax"
    shutil.copytree(ours, theirs)
    os.remove(theirs / "X_selection_plot.pdf")
    jplotting.plot_results_fpath(str(theirs), [2, 3, 4], name="X")
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    assert os.path.getsize(ours / "X_selection_plot.pdf") > 0
    for mod, out in ((plotting, tmp_path / "a"), (jplotting, tmp_path / "b")):
        os.makedirs(out)
        mod.read_plot_factors(str(ours / "3"), (1, 1))
        mod.box_plot([np.ones(4), np.zeros(4)], str(out))
        mod.plot_err([1.0, 0.5, 0.25], str(out / "err.png"))
        mod.plot_W(np.ones((8, 2)), str(out / "w.png"))
        assert {"W.png", "H.png"} <= set(os.listdir(ours / "3"))
    assert sorted(os.listdir(tmp_path / "a")) == sorted(
        os.listdir(tmp_path / "b"))


def test_plot_failure_warns_and_the_sweep_goes_on(tmp_path, monkeypatch,
                                                  timings):
    def broken(*a, **kw):
        raise ImportError("no matplotlib")

    monkeypatch.setattr(plotting, "_plt", broken)
    X = np.random.default_rng(0).random((20, 16))
    cfg = port.NMFkConfig(nmf=port.NMFConfig(norm="fro", itr=20),
                          start_k=1, end_k=2, perturbations=3,
                          results_path=f"{tmp_path}/", fname="X",
                          checkpoint=False)
    with pytest.warns(UserWarning, match="k-selection plot failed"):
        assert port.NMFk(cfg, "cpu").fit(X) in (1, 2)
    np.save(tmp_path / "X.npy", X)
    with pytest.warns(UserWarning, match="timing plot failed"):
        port.Runner(norm="fro", itr=5, device="cpu", timing_stats=True).run(
            fpath=f"{tmp_path}/", ftype="npy", fname="X",
            results_path=f"{tmp_path}/res/", k=2)


def test_timing_stats_parses_as_jax(tmp_path, timings):
    import pandas as pd
    csv = str(tmp_path / "Timing_stats.csv")
    pd.DataFrame([{"read": 0.5, "solve": 2.0, "mystery": 0.1}]).to_csv(csv)
    assert plotting.timing_stats(csv) == jplotting.timing_stats(csv)
    # the port's own CSV (no index column) holds the same numbers
    timing.reset()
    timing.TIMINGS.update({"read": 0.5, "solve": 2.0, "mystery": 0.1})
    own = str(tmp_path / "own.csv")
    timing.save_csv(own)
    assert plotting.timing_stats(own) == jplotting.timing_stats(csv)


def test_runner_writes_the_timing_plot(tmp_path, timings):
    rng = np.random.default_rng(0)
    np.save(tmp_path / "X.npy", rng.random((20, 16)).astype(np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port.Runner(norm="fro", itr=5, device="cpu", timing_stats=True).run(
            fpath=f"{tmp_path}/", ftype="npy", fname="X",
            results_path=f"{tmp_path}/res/", k=2)
    assert os.path.getsize(tmp_path / "res" / "timing.png") > 0
    assert (tmp_path / "res" / "Timing_stats.csv").exists()
    plotting.plot_timing_stats(str(tmp_path / "res" / "Timing_stats.csv"),
                               str(tmp_path))
    assert os.path.getsize(tmp_path / "timing.png") > 0
