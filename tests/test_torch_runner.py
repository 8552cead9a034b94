"""The port's Runner and ``config_from_jax`` take every knob of the JAX
package's Runner and configs: at the values the port runs the same as they
pass, and at any other value they raise NotPortedError naming the ROADMAP
item that ports it (the check list of ``pydnmfk_tpu_torch/config.py``, which
the CLI shares). ``prune``, ``bcd_obj``, the half precisions, ``hbm_budget``,
``kl_chunk``, ``seed_grid``, ``solve_checkpoint_every``,
``sparse_grid_format``, ``k_sweep_batch`` and ``k_sweep_merge`` are ported
and run."""
import dataclasses
import inspect

import numpy as np
import pytest

import pydnmfk_tpu
from pydnmfk_tpu.runner import Runner as JaxRunner
from pydnmfk_tpu_torch import NotPortedError, Runner
from pydnmfk_tpu_torch.config import JAX_ONLY, check_jax_only
from pydnmfk_tpu_torch.utils.convert import config_from_jax

JAX_KNOBS = ("prune", "seed_grid", "solve_checkpoint_every",
             "matmul_precision", "bcd_obj", "sparse_grid_format",
             "k_sweep_batch", "k_sweep_merge")


def _run(tmp_path, **knobs):
    rng = np.random.default_rng(0)
    np.save(tmp_path / "X.npy", rng.random((12, 9)).astype(np.float32))
    knobs = {"norm": "fro", **knobs}
    return Runner(itr=5, device="cpu", **knobs).run(
        fpath=f"{tmp_path}/", ftype="npy", fname="X",
        results_path=f"{tmp_path}/res/", k=2)


def _sweep(tmp_path, **knobs):
    """An FRO NMFk sweep through Runner, ks 2..3, 4 members."""
    rng = np.random.default_rng(0)
    np.save(tmp_path / "X.npy", rng.random((12, 9)).astype(np.float32))
    return Runner(itr=5, device="cpu", norm="fro", process="pyDNMFk",
                  perturbations=4, **knobs).run(
        fpath=f"{tmp_path}/", ftype="npy", fname="X",
        results_path=f"{tmp_path}/res/", k_range=(2, 3))


def _jax_cfg(**kw):
    return dataclasses.asdict(pydnmfk_tpu.NMFConfig(**kw))


@pytest.mark.parametrize("call, item", [
    # prune and bcd_obj are ported: they run (the ids are those of their
    # former refusal cases)
    pytest.param(lambda p: _run(p, prune=True), None,
                 id="<lambda>-queue 1 item 8"),
    # seed_grid and solve_checkpoint_every are ported: they run
    pytest.param(lambda p: _run(p, seed_grid=(2, 2)), None,
                 id="<lambda>-queue 1 item 6"),
    pytest.param(lambda p: _run(p, solve_checkpoint_every=10), None,
                 id="<lambda>-queue 1 item 13"),
    # matmul_precision went to "Not to port": the refusal names it
    pytest.param(lambda p: _run(p, matmul_precision="bfloat16"),
                 'true f32 (ROADMAP.md "Not to port")',
                 id="<lambda>-queue 1 item 1"),
    pytest.param(lambda p: _run(p, method="bcd", bcd_obj="residual"), None,
                 id="<lambda>-queue 1 item 12"),
    # sparse_grid_format is ported: it runs (the ids are those of its
    # former refusal cases; tests/test_torch_grid_sparse.py runs its
    # formats on grids)
    pytest.param(lambda p: _run(p, sparse_grid_format="ell"), None,
                 id="<lambda>-queue 1 item 15_0"),
    # the K-padded sweep and its merged batches are ported: they run (the
    # ids are those of their former refusal cases)
    pytest.param(lambda p: _sweep(p, k_sweep_batch=True), None,
                 id="<lambda>-queue 1 item 10_0"),
    pytest.param(lambda p: _sweep(p, k_sweep_batch=True,
                                  k_sweep_merge=True), None,
                 id="<lambda>-queue 1 item 10_1"),
    pytest.param(lambda p: config_from_jax(_jax_cfg(sparse_grid_format="ell")),
                 None, id="<lambda>-queue 1 item 15_1"),
    (lambda p: config_from_jax(_jax_cfg(use_pallas=True)),
     'dispatch picks the kernel (ROADMAP.md "Not to port")'),
    # the half precisions and the memory knobs are ported: they run
    (lambda p: _run(p, precision="bfloat16"), None),
    (lambda p: _run(p, precision="float16", norm="kl"), None),
    (lambda p: _run(p, a_precision="float16"), None),
    (lambda p: _run(p, hbm_budget=1 << 20, kl_chunk=4), None),
    (lambda p: config_from_jax(_jax_cfg(precision="bfloat16", kl_chunk=8)),
     None),
    (lambda p: config_from_jax(dataclasses.asdict(pydnmfk_tpu.NMFkConfig(
        hbm_budget=1 << 30))), None),
    # the JAX defaults pass
    (lambda p: _run(p, **{
        name: inspect.signature(JaxRunner).parameters[name].default
        for name in JAX_KNOBS}), None),
    (lambda p: config_from_jax(_jax_cfg(sparse_grid_format=None,
                                        use_pallas=False)), None),
])
def test_jax_only_knobs(tmp_path, call, item):
    if item is None:
        assert call(tmp_path) is not None
        return
    with pytest.raises(NotPortedError) as exc:
        call(tmp_path)
    assert item in str(exc.value)


@pytest.mark.parametrize("key", sorted(JAX_ONLY))
def test_every_refusal_names_its_item(key):
    """Each knob left in JAX_ONLY, at a value the port does not run, raises
    NotPortedError naming the ROADMAP entry of its table."""
    accepted, item = JAX_ONLY[key]
    bad = {"grid": (2, 2)}.get(key, "other")
    assert bad not in accepted
    with pytest.raises(NotPortedError) as exc:
        check_jax_only(**{key: bad})
    assert f"(ROADMAP.md {item})" in str(exc.value)
