"""The port on two nodes: ``python -m torch.distributed.run --nnodes=2
--nproc_per_node=1`` twice on 127.0.0.1, one rank a node on a 2 x 1 grid
(the JAX package's tests/test_multihost.py). Each node reads only its
row block of the .npy through DataReader's native reader, and one FRO-MU
step of the grid gives each node's rows of W, and H, within 1e-12 of the
step on the whole matrix in one process, at f64."""
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from pydnmfk_tpu_torch import native
from pydnmfk_tpu_torch.models.updates import mu_fro_step

HERE = os.path.dirname(os.path.abspath(__file__))


def test_two_nodes_read_their_blocks_and_step(tmp_path):
    m, n, k = 16, 8, 3
    A = np.random.default_rng(1).random((m, n))
    np.save(tmp_path / "A.npy", A)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    nodes = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes=2",
         "--nproc_per_node=1", f"--node_rank={r}", "--master_addr=127.0.0.1",
         f"--master_port={port}", os.path.join(HERE,
                                               "_torch_multihost_worker.py"),
         f"{tmp_path}/", str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in nodes:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in nodes:
            p.kill()
    assert all(p.returncode == 0 for p in nodes), "\n".join(outs)
    rng = np.random.default_rng(0)
    W = torch.from_numpy(rng.random((m, k)))
    H = torch.from_numpy(rng.random((k, n)))
    W1, H1 = mu_fro_step(torch.from_numpy(A), W, H, 1e-16)
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        r0, r1 = got["rows"]
        assert (r0, r1) == (8 * r, 8 * r + 8)
        np.testing.assert_array_equal(got["A"].numpy(), A[r0:r1])
        # one block read a node, by the native reader where a compiler
        # builds it (else a numpy memory map, with a warning)
        assert got["npy"] == 1
        assert got["native"] == int(native.get_lib() is not None)
        torch.testing.assert_close(got["W"], W1[r0:r1], rtol=0, atol=1e-12)
        torch.testing.assert_close(got["H"], H1, rtol=0, atol=1e-12)
