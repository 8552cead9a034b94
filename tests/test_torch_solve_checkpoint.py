"""The port's mid-solve checkpoint (``NMF._solve_checkpointed``,
``utils/checkpoint.py::solve_checkpointer``) against an unchunked solve and
against the JAX package's checkpointed solve.

On the CPU a chunked solve is bitwise the unchunked one (FRO-MU, KL-MU,
HALS), and so is a solve resumed after a crash. Against JAX, with JAX's
init factors fed to both: rtol 1e-9 at f64 and 1e-3 at f32 after 120
iterations, the parity tolerances of tests/test_torch_nmf.py."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from _parity import np_, one_thread, x64
import pydnmfk_tpu
import pydnmfk_tpu_torch as port
from pydnmfk_tpu_torch import cli
from pydnmfk_tpu_torch.models import nmf as tnmf
from pydnmfk_tpu_torch.utils import checkpoint as tckpt
from pydnmfk_tpu_torch.utils.convert import config_from_jax

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = {"float64": 1e-9, "float32": 1e-3}
CASES = [dict(norm="fro"), dict(norm="kl"), dict(norm="fro", method="hals"),
         dict(norm="fro", a_precision="uint8"),
         dict(norm="kl", precision="bfloat16")]


def _data():
    rng = np.random.default_rng(0)
    return (rng.random((48, 5)) @ rng.random((5, 36))).astype(np.float32)


def _cfg(path, **kw):
    return port.NMFConfig(**{"k": 5, "itr": 120, **kw},
                          results_path=str(path))


def _count_chunks(monkeypatch):
    """The number of chunks the solve runs (calls with finalize=False)."""
    calls = []
    real = tnmf.solve

    def counting(*a, **kw):
        if not kw.get("finalize", True):
            calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tnmf, "solve", counting)
    return calls


def _crash_after_saves(monkeypatch, n):
    """Make the saver raise right after its n-th save."""
    saves = []
    real = tckpt.SolveCheckpoint.save

    def save(self, W, H, i):
        real(self, W, H, i)
        saves.append(i)
        if len(saves) == n:
            raise RuntimeError("simulated preemption")

    monkeypatch.setattr(tckpt.SolveCheckpoint, "save", save)
    return saves


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "-".join(kw.values()))
def test_chunked_equals_unchunked(tmp_path, monkeypatch, kw):
    A = _data()
    W1, H1, e1 = port.NMF(_cfg(tmp_path / "a", **kw), "cpu").fit(A)
    calls = _count_chunks(monkeypatch)
    cfg = _cfg(tmp_path / "b", solve_checkpoint_every=40, **kw)
    W2, H2, e2 = port.NMF(cfg, "cpu").fit(A)
    assert len(calls) == 3
    assert torch.equal(W1, W2) and torch.equal(H1, H2) and e1 == e2
    assert W2.dtype == cfg.dtype
    assert not os.listdir(tmp_path / "b")      # the checkpoint is gone


@pytest.mark.parametrize("every, chunks", [(25, 6), (5, 12), (40, 3)])
def test_chunks_are_whole_tens(tmp_path, monkeypatch, every, chunks):
    """The clip runs at each chunk's iteration 0, so chunks are multiples
    of 10 (at least 10), as JAX rounds them (nmf.py:538)."""
    A = _data()
    W1, _, e1 = port.NMF(_cfg(tmp_path / "a"), "cpu").fit(A)
    calls = _count_chunks(monkeypatch)
    W2, _, e2 = port.NMF(_cfg(tmp_path / "b", solve_checkpoint_every=every),
                         "cpu").fit(A)
    assert len(calls) == chunks
    assert torch.equal(W1, W2) and e1 == e2


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("norm", ["fro", "kl"])
def test_chunked_matches_jax_solve_checkpointed(tmp_path, norm, precision):
    A = _data().astype(np.float64)
    rng = np.random.default_rng(1)
    W0, H0 = rng.random((48, 5)), rng.random((5, 36))
    jcfg = pydnmfk_tpu.NMFConfig(k=5, norm=norm, itr=120, precision=precision,
                                 solve_checkpoint_every=40,
                                 results_path=str(tmp_path / "jax"))
    with x64():
        Wj, Hj, ej = pydnmfk_tpu.NMF(jcfg).fit(A.astype(jcfg.dtype),
                                               factors=(W0, H0))
        Wj, Hj = np_(Wj), np_(Hj)
    cfg = config_from_jax(dataclasses.asdict(jcfg.replace(
        results_path=str(tmp_path / "torch"))))
    assert cfg.solve_checkpoint_every == 40
    W, H, e = port.NMF(cfg, "cpu").fit(A, factors=(W0, H0))
    rtol = RTOL[precision]
    np.testing.assert_allclose(np_(W), Wj, rtol=rtol, atol=rtol * 1e-3)
    np.testing.assert_allclose(np_(H), Hj, rtol=rtol, atol=rtol * 1e-3)
    np.testing.assert_allclose(e, float(ej), rtol=rtol)


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "-".join(kw.values()))
def test_resume_after_crash(tmp_path, monkeypatch, kw):
    A = _data()
    cfg = _cfg(tmp_path, solve_checkpoint_every=40, **kw)
    W1, H1, e1 = port.NMF(cfg.replace(results_path=str(tmp_path / "g")),
                          "cpu").fit(A)
    saves = _crash_after_saves(monkeypatch, 2)
    with pytest.raises(RuntimeError, match="preemption"):
        port.NMF(cfg, "cpu").fit(A)
    assert saves == [40, 80]
    assert os.path.exists(tmp_path / "solve_ckpt_k5")
    monkeypatch.undo()
    calls = _count_chunks(monkeypatch)
    W2, H2, e2 = port.NMF(cfg, "cpu").fit(A)
    assert len(calls) == 1               # 2 of 3 chunks come from the file
    assert torch.equal(W1, W2) and torch.equal(H1, H2) and e1 == e2
    assert not os.path.exists(tmp_path / "solve_ckpt_k5")


def _leave_checkpoint(tmp_path, monkeypatch, cfg, A):
    _crash_after_saves(monkeypatch, 1)
    with pytest.raises(RuntimeError):
        port.NMF(cfg, "cpu").fit(A)
    monkeypatch.undo()


@pytest.mark.parametrize("change", [dict(itr=160), dict(seed=7),
                                    dict(norm="kl"), dict(a_precision="uint8"),
                                    "A", "torn"])
def test_stale_or_torn_checkpoint_restarts(tmp_path, monkeypatch, change):
    """A file written under another tag (k, itr, norm, method, seed,
    precision, a_precision, A's shape), or a torn one, restarts from 0."""
    A = _data()
    cfg = _cfg(tmp_path, solve_checkpoint_every=40, norm="fro")
    if change == "torn":
        _leave_checkpoint(tmp_path, monkeypatch, cfg, A)
        path = tmp_path / "solve_ckpt_k5"
        path.write_bytes(path.read_bytes()[:100])
    elif change == "A":
        _leave_checkpoint(tmp_path, monkeypatch, cfg, A[:40])
    else:
        _leave_checkpoint(tmp_path, monkeypatch, cfg.replace(**change), A)
    assert os.path.exists(tmp_path / "solve_ckpt_k5")
    W1, _, e1 = port.NMF(cfg.replace(results_path=str(tmp_path / "g")),
                         "cpu").fit(A)
    calls = _count_chunks(monkeypatch)
    W2, _, e2 = port.NMF(cfg, "cpu").fit(A)
    assert len(calls) == 3
    assert torch.equal(W1, W2) and e1 == e2


@pytest.mark.parametrize("kw, match", [
    (dict(tol=1e-4), "tol"), (dict(method="bcd"), "BCD")])
def test_refusals_match_jax(tmp_path, kw, match):
    A = _data()
    jcfg = pydnmfk_tpu.NMFConfig(k=3, norm="fro", itr=50,
                                 solve_checkpoint_every=10,
                                 results_path=str(tmp_path), **kw)
    with pytest.raises(ValueError, match=match) as jexc:
        pydnmfk_tpu.NMF(jcfg).fit(A)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    with pytest.raises(ValueError, match=match) as exc:
        port.NMF(cfg, "cpu").fit(A)
    assert str(exc.value) == str(jexc.value)


def test_cli_and_runner_take_the_knob(tmp_path, monkeypatch):
    np.save(tmp_path / "X.npy", _data())
    base = ["--cpu", "--process=pyDNMF", "--p_r=1", "--p_c=1", "--ftype=npy",
            f"--fpath={tmp_path}/", "--fname=X", "--norm=fro", "--k=5",
            "--itr=120", f"--results_path={tmp_path}/res/"]
    golden = cli.main(base)
    calls = _count_chunks(monkeypatch)
    out = cli.main(base + ["--solve_checkpoint_every=40"])
    assert len(calls) == 3 and out["err"] == golden["err"]
    assert torch.equal(out["W"], golden["W"])
    out = port.Runner(norm="fro", itr=120, device="cpu",
                      solve_checkpoint_every=60).run(
        fpath=f"{tmp_path}/", ftype="npy", fname="X",
        results_path=f"{tmp_path}/res2/", k=5)
    assert len(calls) == 5 and out["err"] == golden["err"]
