"""One node of the port's two-node test (started by
tests/test_torch_multihost.py under ``python -m torch.distributed.run
--nnodes=2 --nproc_per_node=1``): this process joins the group from
torchrun's environment on a 2 x 1 grid, reads its row block of
``DATA_DIR/A.npy`` through ``DataReader`` (the native block reader), takes
one FRO-MU step of the grid at f64 from seeded factors, and saves its
block of the step's W, the step's H and the reads its reader made to
``OUT_DIR/rank{r}.pt``. Imports torch and the port only.

Usage: python _torch_multihost_worker.py DATA_DIR OUT_DIR
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from pydnmfk_tpu_torch import native  # noqa: E402
from pydnmfk_tpu_torch.models.updates import mu_fro_step  # noqa: E402
from pydnmfk_tpu_torch.parallel import mesh  # noqa: E402
from pydnmfk_tpu_torch.utils import io  # noqa: E402

data_dir, out_dir = sys.argv[1], sys.argv[2]
torch.set_num_threads(1)
grid = mesh.initialize(2, 1, "cpu", timeout=60)
assert grid.backend == "gloo" and grid.world_size == 2
A = torch.from_numpy(io.DataReader(data_dir, "A", "npy",
                                   precision="float64").read(grid))
m, n, k = 16, 8, 3
rng = np.random.default_rng(0)
W = torch.from_numpy(rng.random((m, k)))
H = torch.from_numpy(rng.random((k, n)))
r0, r1 = grid.rows(m)
W1, H1 = mu_fro_step(A, W[r0:r1].contiguous(), H, 1e-16, grid=grid)
torch.save({"rank": grid.rank, "rows": (r0, r1), "A": A, "W": W1, "H": H1,
            "native": native.READS["native"],
            "npy": io.BLOCK_READS["npy"]},
           os.path.join(out_dir, f"rank{grid.rank}.pt"))
torch.distributed.destroy_process_group()
