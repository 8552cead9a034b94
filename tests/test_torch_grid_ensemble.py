"""The port's ensemble axis p_e: NMFk's members split over p_e groups of a
p_r x p_c grid of CPU processes (gloo, f64), each group solving its share
on its own ranks, the members gathered over 'e' before the clustering.

* Every member's W and H blocks and error, and every statistic, are
  bitwise those of the p_e = 1 sweep on the same grid (at 1 x 1: of the
  sweep without a grid): at (1,1,e=4) (10 uniform and 6 Poisson members,
  which split unevenly), at (2,1,e=2) (FRO and KL, dense and sparse on the
  triplet and the dual ELL, one batch in which a group has no member) and
  at (2,2,e=2) on 8 ranks. A sum, a restore choice or a clustering that
  reached past its group would mix members and break these.
* A p_e = 2 sweep broken after its second ensemble part resumes to the
  unbroken statistics; the auto batch is a multiple of p_e; a single
  ``NMF.fit`` on (1,1,e=2) gives every group the bits of the fit without a
  grid; the context's collectives stay in the group unless the world is
  named. ``tests/test_torch_grid_ensemble_jax.py`` holds the groups
  against the JAX package's sweep on its mesh axis 'e'.
"""
import numpy as np
import pytest
import torch

from _grid_workers import _triplet, ensemble_checks, run_grid
from _parity import one_thread  # noqa: F401
from pydnmfk_tpu_torch import NMF, NMFConfig, NMFk, NMFkConfig
from pydnmfk_tpu_torch.utils.data_generator import (generate_data,
                                                    generate_topic_sparse)
from test_torch_grid_nmfk import STATS

M, N = 48, 36
BUDGETS = (60_000, 150_000, 600_000)     # bytes: a few members, all


def _planted():
    return np.array(generate_data(m=M, n=N, k=3, seed=1)[2],
                    dtype=np.float64)


def _coo():
    r, c, v, shape = generate_topic_sparse(50, 36, 3, 8, seed=5)
    return r, c, v.astype(np.float64), shape


def _sweep(tmp, name, nmf_kw, **kw):
    kw = {**dict(start_k=2, end_k=4, perturbations=6, sill_thr=0.6,
                 results_path=f"{tmp}/{name}/", fname="A",
                 checkpoint=False), **kw}
    return kw, dict(itr=60, **nmf_kw)


def _no_grid(kw, nmf_kw, A):
    """The sweep in this process without a grid: (nopt, statistics,
    members by k)."""
    import pydnmfk_tpu_torch.models.nmfk as nmfk_mod
    solved = {}
    real = nmfk_mod.NMFk._solve_ensemble

    def solve(self, X, k, members=None):
        solved[k] = real(self, X, k, members)
        return solved[k]

    kw = {**kw, "results_path": kw["results_path"] + "ref/"}
    model = NMFk(NMFkConfig(nmf=NMFConfig(precision="float64", **nmf_kw),
                            **kw), "cpu")
    nmfk_mod.NMFk._solve_ensemble = solve
    try:
        nopt = model.fit(_triplet(A) if isinstance(A, tuple)
                         else torch.from_numpy(A.copy()))
    finally:
        nmfk_mod.NMFk._solve_ensemble = real
    return nopt, model.per_k_stats, solved


def _same_sweep(got, want, name):
    """A sweep on ensemble groups (a rank's nmfk_sweeps output) is bitwise
    the p_e = 1 one: nopt, every statistic, every member's blocks."""
    nopt, stats, _ = got[name]
    ref_nopt, ref_stats, ref_members = want
    assert nopt == ref_nopt, name
    for k, s in ref_stats.items():
        for key in STATS:
            np.testing.assert_array_equal(
                np.asarray(stats[k][key]), np.asarray(s[key]),
                err_msg=f"{name} k={k} {key}")
        for a, b in zip(got["members"][name][k], ref_members[k]):
            assert torch.equal(a, b), f"{name} k={k} members"


def _from_ranks(out, part, name):
    return (out[part][name][0], out[part][name][1], out[part]["members"]
            [name])


# -- bitwise against p_e = 1 --------------------------------------------
@pytest.mark.usefixtures("one_thread")
def test_1x1_over_four_groups_members_are_the_1x1_members(tmp_path):
    """10 uniform members (batch 8: two a group, then one for groups 0
    and 1) and 6 Poisson ones (batch 4, then 2) over p_e = 4, each
    bitwise the sweep's without a grid; rank 0 alone writes."""
    A = _planted()
    sweeps = {"uniform": _sweep(tmp_path, "u", dict(norm="fro"),
                                perturbations=10),
              "poisson": _sweep(tmp_path, "p", dict(norm="kl"),
                                perturbations=6, sampling="poisson",
                                noise_var=0.0, end_k=3)}
    out = run_grid(ensemble_checks, (1, 1, 4), tmp_path, A, None, sweeps,
                   None, BUDGETS, None)
    for name, (kw, nmf_kw) in sweeps.items():
        want = _no_grid(kw, nmf_kw, A)
        for o in out:
            _same_sweep(o["dense"], want, name)
            assert o["dense"]["batch"][name] == {"uniform": 8,
                                                 "poisson": 4}[name]
    assert len(out[0]["dense"]["writes"]) == 3 + 2
    assert all(not o["dense"]["writes"] for o in out[1:])


@pytest.fixture(scope="module")
def runs_2x1(tmp_path_factory):
    """The (2,1,e=2) ranks and the (2,1) ranks of the same sweeps: dense
    FRO (uniform), KL (Poisson, 5 members: batch 4, then one member, which
    group 1 lacks), the FRO sweep broken after each rank's second part and
    resumed (p_e = 2 only), sparse FRO on the triplet and KL on the forced
    ELL; and each context's batches and a single NMF fit."""
    tmp = tmp_path_factory.mktemp("ens_2x1")
    A = _planted()
    sweeps = {"fro": _sweep(tmp, "fro", dict(norm="fro")),
              "kl": _sweep(tmp, "kl", dict(norm="kl"), perturbations=5,
                           sampling="poisson", noise_var=0.0)}
    broken = {"resumed": _sweep(tmp, "res", dict(norm="fro"),
                                checkpoint=True, ensemble_batch=2,
                                break_after=2)}
    sparse = {"triplet": _sweep(tmp, "tri", dict(norm="fro")),
              "ell": _sweep(tmp, "ell", dict(
                  norm="kl", sparse_grid_format="ell"))}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        groups = run_grid(ensemble_checks, (2, 1, 2), tmp, A, _coo(),
                          {**sweeps, **broken}, sparse, BUDGETS,
                          dict(k=3, itr=40))
        one = run_grid(ensemble_checks, (2, 1), tmp, A, _coo(), sweeps,
                       sparse, BUDGETS, None)
    finally:
        torch.set_num_threads(n)
    return groups, one


@pytest.mark.parametrize("part,name", [("dense", "fro"), ("dense", "kl"),
                                       ("sparse", "triplet"),
                                       ("sparse", "ell")])
def test_2x1_over_two_groups_members_are_the_2x1_members(runs_2x1, part,
                                                         name):
    groups, one = runs_2x1
    for rank, o in enumerate(groups):
        _same_sweep(o[part], _from_ranks(one[rank % 2], part, name), name)
    if name == "ell":
        assert all(o["sparse"]["formats"]["ell"] for o in groups)


def test_2x1_sweep_on_groups_resumes_to_the_unbroken_one(runs_2x1):
    """Broken after each rank's second part (k = 2: members 0-1 and 2-3,
    one a group each), the rerun replays them and gives the unbroken
    sweep's statistics and members."""
    groups, one = runs_2x1
    for rank, o in enumerate(groups):
        nopt, stats, saved = o["dense"]["resumed"]
        assert saved == 2 and sorted(stats) == [2, 3, 4]
        ref = _from_ranks(one[rank % 2], "dense", "fro")
        _same_sweep({"resumed": (nopt, stats, 0),
                     "members": {"resumed": o["dense"]["members"]
                                 ["resumed"]}}, ref, "resumed")


def test_auto_batch_is_a_multiple_of_p_e(runs_2x1):
    """Each budget's batch on two groups is p_e times the one group's
    (a rank's share), cut to the 20 members and rounded down to a
    multiple of p_e, and at least p_e (tests/test_ensemble_memory.py:
    83-87)."""
    groups, one = runs_2x1
    share = one[0]["batch"]
    assert share[0] < share[1] < share[2] == 20
    for o in groups:
        assert o["batch"] == [max(2, min(2 * b, 20) // 2 * 2)
                              for b in share]
        assert all(b % 2 == 0 and b >= 2 for b in o["batch"])


def test_context_of_two_groups_of_2x1(runs_2x1):
    """Ranks e * 2 + i; sums, maxima and broadcasts stay in the group
    unless the world is named; 'e' gathers the ranks of one (i, j), and
    broadcasts group 0's."""
    groups, _ = runs_2x1
    for rank, o in enumerate(groups):
        c = o["context"]
        e, i = divmod(rank, 2)
        assert (c["coords"], c["group"], c["p_e"], c["n_ranks"],
                c["world"], c["proc0"]) == ((i, 0), e, 2, 2, 4, rank == 0)
        assert c["sum rc"] == 2 * e + 1 + 2 * e + 2
        assert c["sum r everywhere"] == c["sum rc"]
        assert c["max rc"] == 2 * e + 2 and c["max world"] == 4
        assert c["broadcast rc"] == 2 * e + 1
        assert c["broadcast e"] == i + 1 and c["broadcast world"] == 1
        assert torch.equal(c["gather e"], torch.tensor(
            [[i, i], [2 + i, 2 + i], [2 + i, 2 + i]], dtype=torch.float32))
        assert "3 groups of a 2x1 grid needs 6 ranks" in c["refused"]


def test_single_nmf_on_two_groups_gives_every_group_the_same_bits(
        runs_2x1):
    """NMF.fit on (2,1,e=2): every rank the gathered factors and error of
    the fit on one 2 x 1 group (the grid sums in its own order)."""
    groups, _ = runs_2x1
    W, H, err = groups[0]["nmf"]
    for o in groups[1:]:
        assert torch.equal(o["nmf"][0], W) and torch.equal(o["nmf"][1], H)
        assert o["nmf"][2] == err
    ref = NMF(NMFConfig(precision="float64", k=3, itr=40), "cpu").fit(
        torch.from_numpy(_planted()))
    np.testing.assert_allclose(W.numpy(), ref[0].numpy(), rtol=1e-9,
                               atol=1e-12)
    assert abs(err / ref[2] - 1) < 1e-9


@pytest.mark.usefixtures("one_thread")
def test_1x1_over_two_groups_single_nmf_is_the_no_grid_fit(tmp_path):
    """A single NMF.fit on (1,1,e=2), rand init: every group the bits of
    the fit without a grid."""
    A = _planted()
    out = run_grid(ensemble_checks, (1, 1, 2), tmp_path, A, None, None,
                   None, (), dict(k=3, itr=40))
    W, H, err = NMF(NMFConfig(precision="float64", k=3, itr=40),
                    "cpu").fit(torch.from_numpy(A.copy()))
    for o in out:
        assert torch.equal(o["nmf"][0], W) and torch.equal(o["nmf"][1], H)
        assert o["nmf"][2] == err


@pytest.mark.usefixtures("one_thread")
def test_2x2_over_two_groups_on_eight_ranks(tmp_path):
    """(2,2,e=2), 8 ranks: each member's blocks and every statistic are
    the 2 x 2 sweep's, bitwise."""
    A = _planted()
    sweeps = {"fro": _sweep(tmp_path, "fro", dict(norm="fro"), end_k=3)}
    groups = run_grid(ensemble_checks, (2, 2, 2), tmp_path, A, None,
                      sweeps, None, (), None)
    one = run_grid(ensemble_checks, (2, 2), tmp_path, A, None,
                   {"fro": _sweep(tmp_path, "one", dict(norm="fro"),
                                  end_k=3)}, None, (), None)
    for rank, o in enumerate(groups):
        _same_sweep(o["dense"], _from_ranks(one[rank % 4], "dense", "fro"),
                    "fro")
    assert all(not o["dense"]["writes"] for o in groups[1:])
