"""The grid through the port's entry points on the CPU: the CLI under
``python -m torch.distributed.run --standalone --nproc_per_node=4 -m
pydnmfk_tpu_torch --cpu --p_r=2 --p_c=2`` (an NMFk sweep: one k printed,
by rank 0; each k's results and factor chunks, named and laid out as the
JAX package's DataWriter writes them on a 2 x 2 grid, ``read_factors`` of
both packages giving the same factors back); ``Runner.run`` on a 2 x 2
group, each rank reading its block of an .npy, a .mat and a 2 x 2
``folder`` (the same fit as 1x1 from each) and its row panel of an .npz
(the same fit as a sparse A), NMF and NMFk of a sparse A; and a run in
which one rank fails, which ends non-zero instead of hanging."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import savemat

from _grid_workers import run_grid, runner_reads
from _parity import one_thread  # noqa: F401
from pydnmfk_tpu.utils import io as jio
from pydnmfk_tpu_torch import Runner
from pydnmfk_tpu_torch.parallel.partition import block_range
from pydnmfk_tpu_torch.utils import io
from pydnmfk_tpu_torch.utils.data_generator import generate_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node=4", "-m", "pydnmfk_tpu_torch", "--cpu",
            "--p_r=2", "--p_c=2"]
# a whole torchrun of four CPU ranks, startup included
RUN_TIMEOUT = 180


def _torchrun(args, cwd):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.run(TORCHRUN + args, cwd=cwd, env=env,
                          capture_output=True, text=True,
                          timeout=RUN_TIMEOUT)


def _planted():
    return np.array(generate_data(m=48, n=36, k=3, seed=1)[2],
                    dtype=np.float64)


def test_cli_sweep_under_torchrun(tmp_path):
    np.save(tmp_path / "X.npy", _planted())
    run = _torchrun(["--process=pyDNMFk", "--ftype=npy", "--fname=X",
                     f"--fpath={tmp_path}/", "--norm=fro", "--itr=100",
                     "--start_k=2", "--end_k=4", "--perturbations=6",
                     "--precision=float64",
                     f"--results_path={tmp_path}/res/"], tmp_path)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.count("Rank estimated by NMFk = 3") == 1, run.stdout
    for k in (2, 3, 4):
        k_dir = tmp_path / "res" / "X" / str(k)
        assert io.read_cluster_results(str(k_dir))["L_err"].shape == (36,)
        W, H = io.read_factors(str(k_dir), (2, 2))
        assert W.shape == (48, k) and H.shape == (k, 36)
        # the JAX package's writer lays the same factors out alike, and
        # its reader gives them back
        jdir = tmp_path / "jax" / str(k)
        jio.DataWriter(str(jdir), (2, 2)).save_factors(W, H, reg=True)
        for name in ("W_reg_factors", "H_reg_factors"):
            files = sorted(os.listdir(k_dir / name))
            assert files == sorted(os.listdir(jdir / name))
            assert len(files) == 4
            for f in files:
                np.testing.assert_array_equal(np.load(k_dir / name / f),
                                              np.load(jdir / name / f))
        Wj, Hj = jio.read_factors(str(k_dir), (2, 2))
        np.testing.assert_array_equal(Wj, W)
        np.testing.assert_array_equal(Hj, H)


@pytest.mark.usefixtures("one_thread")
def test_runner_reads_each_rank_block(tmp_path):
    A = _planted()
    np.save(tmp_path / "X.npy", A)
    savemat(tmp_path / "X.mat", {"X": A})
    for i in range(2):
        r0, r1 = block_range(A.shape[0], 2, i)
        for j in range(2):
            c0, c1 = block_range(A.shape[1], 2, j)
            np.save(tmp_path / f"F{i * 2 + j}.npy", A[r0:r1, c0:c1])
    import scipy.sparse as sp
    sp.save_npz(tmp_path / "S.npz", sp.csr_matrix(A))
    reads = [("npy", "X"), ("mat", "X"), ("folder", "F"), ("npz", "S")]
    out = run_grid(runner_reads, (2, 2), tmp_path, f"{tmp_path}/",
                   str(tmp_path / "grid"), reads)
    ref = Runner(norm="fro", itr=30, precision="float64",
                 device="cpu").run(fpath=f"{tmp_path}/", ftype="npy",
                                   fname="X", k=3,
                                   results_path=f"{tmp_path}/one/")
    for rank in out:
        for ftype in ("npy", "mat", "folder"):
            got = rank[ftype]
            assert torch.equal(got["W"], rank["npy"]["W"])
            np.testing.assert_allclose(got["err"], ref["err"], rtol=1e-12)
            np.testing.assert_allclose(got["W"].numpy(), ref["W"].numpy(),
                                       rtol=0, atol=1e-12)
        # the .npz runs as a sparse A on the grid (every entry of the
        # planted matrix is nonzero): the same fit by the Gram identity's
        # error, to f64 cancellation
        got = rank["npz"]
        np.testing.assert_allclose(got["err"], ref["err"], rtol=1e-8)
        np.testing.assert_allclose(got["W"].numpy(), ref["W"].numpy(),
                                   rtol=0, atol=1e-10)
        # NMF and NMFk of a whole triplet on the grid run
        W, H, err = rank["nmf"]
        assert W.shape == (3, 1) and H.shape == (1, 3) and np.isfinite(err)
        assert rank["nmfk"] == 1
    W, H = io.read_factors(str(tmp_path / "grid" / "npy"), (2, 2),
                           reg=False)
    np.testing.assert_array_equal(W, out[0]["npy"]["W"].numpy())
    np.testing.assert_array_equal(H, out[0]["npy"]["H"].numpy())


def test_a_failing_rank_ends_the_run(tmp_path):
    """Rank 3's chunk file is missing: it raises, prints its traceback and
    exits 1; the others' collectives end and the run exits non-zero well
    inside its deadline."""
    A = _planted()
    for rank in range(3):
        i, j = divmod(rank, 2)
        r0, r1 = block_range(A.shape[0], 2, i)
        c0, c1 = block_range(A.shape[1], 2, j)
        np.save(tmp_path / f"F{rank}.npy", A[r0:r1, c0:c1])
    run = _torchrun(["--process=pyDNMF", "--ftype=folder", "--fname=F",
                     f"--fpath={tmp_path}/", "--norm=fro", "--k=3",
                     "--itr=10", f"--results_path={tmp_path}/res/"],
                    tmp_path)
    assert run.returncode != 0
    assert "F3.npy" in run.stderr
