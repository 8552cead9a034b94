"""Mid-k resume of the port's NMFk sweep from ``ensemble_parts/``
(``models/nmfk.py::_save_ensemble_part``, ``_load_ensemble_parts``; JAX
``nmfk.py:468-488``, ``:546-622``, ``:898-909``, ``:997-1000``, ``:1316``).

A sweep that fails after a saved part and runs again gives bitwise the
unbroken sweep's per-k statistics on the CPU, and solves only the members
that no part holds. Unlike the JAX package's (ROADMAP queue 3), the parts'
tag holds ``bcd_obj`` and ``hals_block``."""
import os

import numpy as np
import pytest

import pydnmfk_tpu
from pydnmfk_tpu.models import nmfk as jnmfk
from pydnmfk_tpu.utils.data_generator import generate_data
import pydnmfk_tpu_torch as port
from pydnmfk_tpu_torch.models import nmf as tnmf
from pydnmfk_tpu_torch.models import nmfk as tnmfk
from pydnmfk_tpu_torch.models import clustering as tclustering
from pydnmfk_tpu_torch.utils import plotting
from pydnmfk_tpu_torch.utils.io import RESULT_DATASETS, read_cluster_results
from _parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread", "no_plot")


@pytest.fixture
def no_plot():
    """The sweeps here skip their selection plot (a PDF each, about as long
    as one of these small sweeps); tests/test_torch_timing_plotting.py
    checks the plot. Its own patch, which the tests' monkeypatch.undo()
    leaves in place."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(plotting, "plot_results_fpath", lambda *a, **kw: None)
        yield

_, _, X = generate_data(m=64, n=48, k=3, seed=100)
X = X.astype(np.float32)


def _cfg(path, **kw):
    nmf_kw = {key: kw.pop(key) for key in list(kw)
              if key in ("method", "bcd_obj", "hals_block", "norm")}
    return port.NMFkConfig(
        nmf=port.NMFConfig(**{"norm": "fro", "itr": 50, **nmf_kw}),
        **{"start_k": 2, "end_k": 4, "perturbations": 6,
           "ensemble_batch": 2, **kw},
        results_path=str(path) + "/", fname="X", checkpoint=True)


def _count_members(monkeypatch):
    """Members solved in ensemble stacks (solves of a 3-D A)."""
    solved = []
    real = tnmf.solve

    def counting(A, W, *a, **kw):
        if W.dim() == 3:
            solved.append(W.shape[0])
        return real(A, W, *a, **kw)

    monkeypatch.setattr(tnmf, "solve", counting)
    return solved


def _fail_after_part(monkeypatch, k, offset):
    """Make the sweep raise right after k's part at ``offset`` is saved."""
    real = tnmfk._save_ensemble_part

    def save(parts_dir, off, *a):
        real(parts_dir, off, *a)
        if off == offset and os.path.basename(
                os.path.dirname(parts_dir)) == str(k):
            raise RuntimeError("simulated preemption")

    monkeypatch.setattr(tnmfk, "_save_ensemble_part", save)


def _stats(cfg):
    return {k: read_cluster_results(os.path.join(cfg.results_path, "X",
                                                 str(k)))
            for k in cfg.k_range}


def _assert_same_stats(a, b):
    assert set(a) <= set(b)
    for k in a:
        for name in RESULT_DATASETS:
            np.testing.assert_array_equal(a[k][name], b[k][name],
                                          err_msg=f"k={k} {name}")


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    cfg = _cfg(tmp_path_factory.mktemp("unbroken"))
    nopt = port.NMFk(cfg, "cpu").fit(X)
    return nopt, _stats(cfg)


@pytest.mark.parametrize("replay_batch", [2, 4])
def test_resume_after_a_part_gives_the_unbroken_sweep(tmp_path, monkeypatch,
                                                      unbroken, replay_batch):
    cfg = _cfg(tmp_path)
    _fail_after_part(monkeypatch, 3, 0)
    with pytest.raises(RuntimeError, match="preemption"):
        port.NMFk(cfg, "cpu").fit(X)
    parts = tmp_path / "X" / "3" / "ensemble_parts"
    assert sorted(os.listdir(parts)) == ["part_000000.pt"]
    assert not (tmp_path / "X" / "2" / "ensemble_parts").exists()
    monkeypatch.undo()
    solved = _count_members(monkeypatch)
    model = port.NMFk(cfg.replace(ensemble_batch=replay_batch), "cpu")
    nopt = model.fit(X)
    # k = 3: members 2-5, k = 4: all 6 (k = 2 was saved before the failure)
    assert sum(solved) == 4 + 6
    assert nopt == unbroken[0] == 3
    _assert_same_stats(_stats(cfg), unbroken[1])
    assert not any((tmp_path / "X" / str(k) / "ensemble_parts").exists()
                   for k in cfg.k_range)


def test_failure_in_the_clustering_replays_every_member(tmp_path, monkeypatch,
                                                         unbroken):
    """A failure after the ensemble (FLAG_PERTS_DONE) resumes from the
    parts alone (nmfk.py:898-909)."""
    cfg = _cfg(tmp_path)
    real = tclustering.cluster_ensemble

    def failing(W_all, *a, **kw):
        if W_all.shape[-1] == 3:
            raise RuntimeError("simulated preemption")
        return real(W_all, *a, **kw)

    monkeypatch.setattr(tnmfk, "cluster_ensemble", failing)
    with pytest.raises(RuntimeError, match="preemption"):
        port.NMFk(cfg, "cpu").fit(X)
    monkeypatch.undo()
    solved = _count_members(monkeypatch)
    port.NMFk(cfg, "cpu").fit(X)
    assert sum(solved) == 6            # only k = 4's members
    _assert_same_stats(_stats(cfg), unbroken[1])


@pytest.mark.parametrize("base, change", [
    (dict(), dict(noise_var=0.03)),
    (dict(method="bcd", bcd_obj="gram"), dict(bcd_obj="residual")),
    (dict(method="hals"), dict(hals_block=2))])
def test_changed_setting_recomputes(tmp_path, monkeypatch, base, change):
    cfg = _cfg(tmp_path, **base)
    _fail_after_part(monkeypatch, 3, 2)
    with pytest.raises(RuntimeError, match="preemption"):
        port.NMFk(cfg, "cpu").fit(X)
    assert len(os.listdir(tmp_path / "X" / "3" / "ensemble_parts")) == 2
    monkeypatch.undo()
    if "noise_var" in change:
        new = cfg.replace(**change)
    else:
        new = cfg.replace(nmf=cfg.nmf.replace(**change))
    solved = _count_members(monkeypatch)
    port.NMFk(new, "cpu").fit(X)
    assert sum(solved) == 6 + 6        # k = 3 and 4 in full


def test_the_jax_tag_misses_what_the_port_tag_holds():
    """The JAX package's tag is blind to bcd_obj and hals_block (ADVICE
    r5, ROADMAP queue 3); the port's is not."""
    for a, b in ((dict(method="bcd", bcd_obj="gram"),
                  dict(method="bcd", bcd_obj="residual")),
                 (dict(method="hals"), dict(method="hals", hals_block=2))):
        jcfg = pydnmfk_tpu.NMFkConfig(nmf=pydnmfk_tpu.NMFConfig(norm="fro"))
        ja, jb = (jcfg.nmf.replace(**d) for d in (a, b))
        assert jnmfk._ensemble_cfg_tag(ja, jcfg) == jnmfk._ensemble_cfg_tag(
            jb, jcfg)
        cfg = port.NMFkConfig()
        pa, pb = (port.NMFConfig(norm="fro", **d) for d in (a, b))
        assert tnmfk._ensemble_cfg_tag(pa, cfg) != tnmfk._ensemble_cfg_tag(
            pb, cfg)
    # and the width the members are solved at (a K-padded sweep's K)
    ncfg = port.NMFConfig(k=3)
    assert tnmfk._ensemble_cfg_tag(ncfg, cfg) != tnmfk._ensemble_cfg_tag(
        ncfg, cfg, K=8)


def test_torn_parts_are_ignored(tmp_path, monkeypatch, unbroken):
    cfg = _cfg(tmp_path)
    _fail_after_part(monkeypatch, 3, 2)
    with pytest.raises(RuntimeError):
        port.NMFk(cfg, "cpu").fit(X)
    monkeypatch.undo()
    parts = tmp_path / "X" / "3" / "ensemble_parts"
    torn = parts / "part_000002.pt"
    torn.write_bytes(torn.read_bytes()[:64])
    (parts / "part_000004.pt.tmp").write_bytes(b"half a write")
    solved = _count_members(monkeypatch)
    port.NMFk(cfg, "cpu").fit(X)
    assert sum(solved) == 4 + 6        # part 0 replays, 2-5 recomputed
    _assert_same_stats(_stats(cfg), unbroken[1])


def test_shrunk_perturbations_are_cut(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path)
    _fail_after_part(monkeypatch, 3, 2)
    with pytest.raises(RuntimeError):
        port.NMFk(cfg, "cpu").fit(X)
    monkeypatch.undo()
    small = cfg.replace(perturbations=3)
    solved = _count_members(monkeypatch)
    port.NMFk(small, "cpu").fit(X)
    assert sum(solved) == 3            # k = 3 from its 4 saved members
    gold = small.replace(results_path=str(tmp_path / "gold") + "/",
                         checkpoint=False)
    port.NMFk(gold, "cpu").fit(X)
    # k = 2 was saved with 6 members before the failure
    resumed, want = _stats(small), _stats(gold)
    _assert_same_stats({k: resumed[k] for k in (3, 4)}, want)


def test_parts_are_written_and_gone_after_the_results(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path)
    written = []
    real = tnmfk._save_ensemble_part

    def save(parts_dir, off, *a):
        real(parts_dir, off, *a)
        written.append((os.path.basename(os.path.dirname(parts_dir)), off))

    monkeypatch.setattr(tnmfk, "_save_ensemble_part", save)
    port.NMFk(cfg, "cpu").fit(X)
    assert written == [(str(k), off) for k in cfg.k_range
                       for off in (0, 2, 4)]
    assert not any((tmp_path / "X" / str(k) / "ensemble_parts").exists()
                   for k in cfg.k_range)
    # without checkpoint no part is written
    written.clear()
    port.NMFk(cfg.replace(checkpoint=False,
                          results_path=str(tmp_path / "b") + "/"),
              "cpu").fit(X)
    assert written == []
