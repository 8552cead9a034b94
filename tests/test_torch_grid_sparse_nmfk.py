"""The port's sparse NMFk sweep on a p_r x p_c grid of CPU processes against
its 1x1 sweep: a rank's block of every member is bitwise the 1x1 member's
(uniform and Poisson noise: each member's whole flat values are drawn and
the block's slots kept), on 2 x 2 and on the uneven 3 x 1; the 2 x 2 FRO-MU
and KL-MU sweeps, the 2 x 2 FRO-MU sweep with the dual ELL forced on every
rank and the 3 x 1 FRO-MU sweep choose the 1x1 sweep's k, with the
statistics within the tolerances of ``tests/test_torch_grid_nmfk.py``; a
sparse grid sweep broken after its third ensemble part resumes from each
rank's parts to the unbroken statistics. The matrix is a planted rank-3
50 x 36 topic matrix (``generate_topic_sparse``, 8 nonzeros a row), whose
rows 3 x 1 cuts into blocks of 17, 17 and 16."""
import numpy as np
import pytest
import torch

from _grid_workers import _triplet, run_grid, sparse_nmfk_checks
from _parity import one_thread  # noqa: F401
from pydnmfk_tpu_torch import NMFConfig, NMFk, NMFkConfig
from pydnmfk_tpu_torch.models import sampler
from pydnmfk_tpu_torch.utils.data_generator import generate_topic_sparse
from test_torch_grid_nmfk import _check_sweep, _sweep

M, N = 50, 36
DRAWS = {"uniform": (100, 0.03, "uniform", [0, 3]),
         "poisson": (7, 0.0, "poisson", [1, 2])}


def _coo():
    r, c, v, shape = generate_topic_sparse(M, N, 3, 8, seed=5)
    return r, c, v.astype(np.float64), shape


def _reference(kw, nmf_kw, coo):
    """The 1x1 sweep of the same configuration on the whole triplet."""
    kw = {key: v for key, v in kw.items() if key != "break_after"}
    kw["results_path"] += "ref/"
    model = NMFk(NMFkConfig(nmf=NMFConfig(precision="float64", **nmf_kw),
                            **kw), "cpu")
    return model.fit(_triplet(coo)), model.per_k_stats


def _check_draws(draws, coo):
    """Each rank's block of a member is the 1x1 member's values at the
    block's slots, bitwise, and the blocks' slots cover every nonzero
    once."""
    A = _triplet(coo)
    for name, (seed, nv, method, idx) in DRAWS.items():
        whole = sampler.sample_ensemble(A.data, seed, nv, idx, method)
        for perm, block in (rank[name] for rank in draws):
            assert block.shape == (len(idx), perm.numel())
            assert torch.equal(block, whole[:, perm]), name
        perms = torch.cat([rank[name][0] for rank in draws])
        assert torch.equal(perms.sort().values, torch.arange(A.nse))


@pytest.mark.usefixtures("one_thread")
def test_2x2_sparse_sweeps_members_and_resume(tmp_path):
    coo = _coo()
    sweeps = {"fro": _sweep(tmp_path, "fro", dict(norm="fro")),
              "kl": _sweep(tmp_path, "kl", dict(norm="kl")),
              "ell": _sweep(tmp_path, "ell", dict(norm="fro",
                                                  sparse_grid_format="ell")),
              "resumed": _sweep(tmp_path, "res", dict(norm="fro"),
                                checkpoint=True, ensemble_batch=4,
                                break_after=3)}
    out = run_grid(sparse_nmfk_checks, (2, 2), tmp_path, coo, DRAWS, sweeps)
    _check_draws([o["draws"] for o in out], coo)
    fro = _reference(*sweeps["fro"], coo)
    kl = _reference(*sweeps["kl"], coo)
    assert fro[0] == kl[0] == 3
    for o in out:
        assert o["sweeps"]["formats"] == {"fro": False, "kl": False,
                                          "ell": True, "resumed": False}
        _check_sweep(o["sweeps"]["fro"], fro)
        _check_sweep(o["sweeps"]["kl"], kl)
        # the dual ELL, forced, against the triplet blocks: the same k and
        # statistics (each format sums its products in its own order)
        _check_sweep(o["sweeps"]["ell"], o["sweeps"]["fro"][:2])
        # parts 1, 2 (k = 2) and 1 (k = 3) saved, then it broke; the rerun
        # replays k = 3's first part on every rank
        nopt, stats, saved = o["sweeps"]["resumed"]
        assert saved == 3 and sorted(stats) == [3, 4]
        _check_sweep((nopt, stats, 0), fro)
    assert not (tmp_path / "res" / "A" / "3" / "ensemble_parts").exists()


@pytest.mark.usefixtures("one_thread")
def test_3x1_sparse_members_and_sweep(tmp_path):
    coo = _coo()
    sweeps = {"fro": _sweep(tmp_path, "fro", dict(norm="fro"))}
    out = run_grid(sparse_nmfk_checks, (3, 1), tmp_path, coo, DRAWS, sweeps)
    _check_draws([o["draws"] for o in out], coo)
    ref = _reference(*sweeps["fro"], coo)
    for o in out:
        _check_sweep(o["sweeps"]["fro"], ref)
