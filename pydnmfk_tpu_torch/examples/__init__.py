"""The JAX package's nine examples (``examples/*.py``) on pydnmfk_tpu_torch.

Each runs on the CUDA card unless given ``--cpu``, as
``python -m pydnmfk_tpu_torch.examples.<name>``, and exposes ``main(...)``,
whose keyword arguments default to the JAX example's configuration and
assertions (a caller may pass smaller depths or its own expected answer):

* ``nmfk_wtsi``, ``runner_example``, ``multihost_nmfk``: NMFk on
  ``wtsi.mat`` (nopt = 4), by the library, the Runner and a grid of
  processes;
* ``nmfk_swim``: KL NMFk on ``swim.mat`` under the reference's MPI seeding
  (nopt = 16);
* ``quantized_swim``: ``a_precision="uint8"`` against f32 on ``swim.mat``;
* ``sparse_npz``: ``swim.mat`` as a scipy ``.npz`` through the Runner, and
  sparse NMFk on a planted matrix;
* ``large_scale``, ``nmfk_large``, ``sparse_ell_beyond_hbm``: synthetic
  inputs drawn from seeds.

The examples that read ``wtsi.mat`` (96 x 21 uint16) or ``swim.mat``
(1024 x 256 uint8), the reference's sample data, take its directory as
``--data_path`` (default ``DATA_PATH``).
"""
import argparse

# the directory of the reference's sample data, relative to the working
# directory (the reference package's own layout)
DATA_PATH = "data/"


def parse(doc: str, data: bool = False, ints=(), argv=None) -> dict:
    """The keyword arguments of an example's ``main`` from its command line:
    ``device`` ("cpu" under ``--cpu``, else "cuda"), ``data_path`` where
    ``data`` (``--data_path``), and the positional integers named by
    ``ints``, those given."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    if data:
        ap.add_argument("--data_path", default=DATA_PATH,
                        help="the directory of wtsi.mat / swim.mat")
    if ints:
        ap.add_argument("ints", nargs="*", type=int, metavar="|".join(ints))
    args = ap.parse_args(argv)
    kw = {"device": "cpu" if args.cpu else "cuda"}
    if data:
        kw["data_path"] = args.data_path
    if ints:
        kw.update(zip(ints, args.ints))
    return kw
