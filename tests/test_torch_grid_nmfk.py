"""The port's NMFk sweep on a p_r x p_c grid of CPU processes against its
1x1 sweep: a rank's block of every member is bitwise the 1x1 member's
(uniform and Poisson noise keyed by row panels, also on a pruned A, and on
an uneven grid; the reference's MPI seeding, ``seed_grid`` the run's
grid); the 2 x 2 sweeps (FRO-MU, KL-MU) and an uneven 3 x 1 HALS
sweep from nnsvd on a pruned A choose the 1x1 sweep's k, with the per-k
errors and AIC within 1e-8 at f64 (the grid sums its products in another
order) and the statistics downstream of the clustering's f32 sums within the
tolerances of ``TOL``; a grid sweep broken after its second ensemble part resumes from
each rank's parts to the unbroken statistics; a checkpointed grid solve,
broken after its second save, resumes from each rank's shard file."""
import os

import numpy as np
import pytest
import torch

from _grid_workers import nmfk_checks, run_grid
from _parity import one_thread  # noqa: F401
from pydnmfk_tpu_torch import NMFConfig, NMFk, NMFkConfig
from pydnmfk_tpu_torch.models import sampler
from pydnmfk_tpu_torch.utils.data_generator import generate_data
from pydnmfk_tpu_torch.utils.pruning import prune_A

M, N = 48, 36
# (rtol, atol) of the statistics downstream of the clustering; the
# ensemble's errors and AIC (f64) agree to 1e-8. The clustering sums W's
# columns and its Gram in f32, as the reference does (clustering.py:40-41,
# :98): the grid sums them in another order, which moves the centroids by
# up to f32's eps (6e-8) relative, the refit's column errors (residuals of
# about 3e-3 of A) by that over 3e-3, and the silhouettes, in [-1, 1],
# more, since the arccos of Gram entries near 1 magnifies it
TOL = {"clusterSilhouetteCoefficients": (0, 1e-4),
       "avgSilhouetteCoefficients": (0, 1e-4), "L_errDist": (1e-4, 0),
       "L_err": (1e-4, 1e-12)}
STATS = ("clusterSilhouetteCoefficients", "avgSilhouetteCoefficients",
         "L_errDist", "L_err", "avgErr", "recon_err", "AIC")
DRAWS = {"uniform": (100, 0.03, "uniform", [0, 3], False),
         "poisson": (7, 0.0, "poisson", [1], False),
         "pruned": (100, 0.03, "uniform", [2], True)}


def _planted(zero=False):
    A = np.array(generate_data(m=M, n=N, k=3, seed=1)[2], dtype=np.float64)
    if zero:
        A[::7] = 0
        A[:, ::5] = 0
    return A


def _sweep(tmp, name, nmf_kw, **kw):
    kw = {**dict(start_k=2, end_k=4, perturbations=6, sill_thr=0.6,
                 results_path=f"{tmp}/{name}/", fname="A",
                 checkpoint=False), **kw}
    return kw, dict(itr=100, **nmf_kw)


def _check_sweep(got, want):
    nopt, stats, _ = got
    ref_nopt, ref = want
    assert nopt == ref_nopt
    for k, s in ref.items():
        if k not in stats:          # a resumed sweep skips its saved ks
            continue
        for key in STATS:
            rtol, atol = TOL.get(key, (1e-8, 1e-12))
            np.testing.assert_allclose(np.asarray(stats[k][key],
                                                  dtype=np.float64),
                                       np.asarray(s[key], dtype=np.float64),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"k={k} {key}")


def _reference(kw, nmf_kw, A):
    kw = {key: v for key, v in kw.items() if key != "break_after"}
    model = NMFk(NMFkConfig(nmf=NMFConfig(precision="float64", **nmf_kw),
                            **{**kw, "results_path": kw["results_path"]
                               + "ref/"}), "cpu")
    return model.fit(torch.from_numpy(A.copy())), model.per_k_stats


def _check_draws(draws, A, cases=DRAWS):
    for name, (seed, nv, method, idx, prune, *tile) in cases.items():
        At = torch.from_numpy(A.copy())
        if prune:
            At, _ = prune_A(At)
        whole = sampler.sample_ensemble(At, seed, nv, idx, method,
                                        tile_grid=tile[0] if tile else None)
        for rank in draws:
            ((r0, r1, m), (c0, c1, n)), block = rank[name]
            assert (m, n) == tuple(At.shape)
            assert torch.equal(block, whole[:, r0:r1, c0:c1]), name


@pytest.mark.usefixtures("one_thread")
def test_2x2_sweeps_members_and_resume(tmp_path):
    A = _planted()
    sweeps = {"fro": _sweep(tmp_path, "fro", dict(norm="fro")),
              "kl": _sweep(tmp_path, "kl", dict(norm="kl")),
              "resumed": _sweep(tmp_path, "res", dict(norm="fro"),
                                checkpoint=True, ensemble_batch=4,
                                break_after=3)}
    draws = {**DRAWS, "seed_grid": (100, 0.03, "uniform", [4], False,
                                    (2, 2))}
    out = run_grid(nmfk_checks, (2, 2), tmp_path, A, draws, sweeps,
                   str(tmp_path / "solve"))
    _check_draws([o["draws"] for o in out], A, draws)
    fro = _reference(*sweeps["fro"], A)
    assert fro[0] == 3
    for o in out:
        _check_sweep(o["sweeps"]["fro"], fro)
        _check_sweep(o["sweeps"]["kl"], _reference(*sweeps["kl"], A)
                     if o is out[0] else out[0]["sweeps"]["kl"][:2])
        # the resumed sweep: parts 1, 2 (k = 2) and 1 (k = 3) saved, then
        # it broke; the rerun replays k = 3's first part on every rank
        nopt, stats, saved = o["sweeps"]["resumed"]
        assert saved == 3 and sorted(stats) == [3, 4]
        _check_sweep((nopt, stats, 0), fro)
        err, resumed, saves, left = o["solve"]
        assert saves == [30, 40] and resumed == err
        assert left == [f"solve_ckpt_k3_r{r}" for r in range(4)]
    # rank 0 alone wrote each k's results (ks 2-4 of two sweeps; k = 2 of
    # the broken one, then k = 3 and 4), in the 2 x 2 chunk layout
    assert len(out[0]["sweeps"]["writes"]) == 3 + 3 + 1 + 2
    assert all(not o["sweeps"]["writes"] for o in out[1:])
    k_dir = tmp_path / "fro" / "A" / "3"
    assert sorted(os.listdir(k_dir / "W_reg_factors")) == \
        [f"W_{b}.npy" for b in range(4)]
    assert not os.path.exists(tmp_path / "res" / "A" / "3" /
                              "ensemble_parts")


@pytest.mark.usefixtures("one_thread")
def test_3x1_pruned_nnsvd_hals_sweep(tmp_path):
    A = _planted(zero=True)
    sweeps = {"hals": _sweep(tmp_path, "hals", dict(
        norm="fro", method="hals", init="nnsvd", prune=True))}
    out = run_grid(nmfk_checks, (3, 1), tmp_path, A, DRAWS, sweeps)
    _check_draws([o["draws"] for o in out], A)
    ref = _reference(*sweeps["hals"], A)
    for o in out:
        _check_sweep(o["sweeps"]["hals"], ref)
    W = np.load(tmp_path / "hals" / "A" / "3" / "W_reg_factors" / "W_0.npy")
    assert W.shape[1] == 3 and not W[0].any()     # row 0 was pruned
