"""pydnmfk_tpu_torch at the half precisions against pydnmfk_tpu: bf16 and f16
factors, an f16 A, uint8 A under half factors, and the memory knobs
(hbm_budget, kl_chunk). Inputs come from numpy seeds and go through both
packages, JAX on the CPU (its Pallas kernels in interpret mode).

Tolerances, stated per test, follow from the rounding of the half dtypes:
one bf16 ulp is 2^-8 (3.9e-3) of a value, one f16 ulp 2^-11 (4.9e-4). The
JAX package's XLA keeps some elementwise intermediates in f32 where the port
rounds each operation to the factor dtype, so single steps agree to a few
ulps; over whole fits the trajectories drift apart, and fits are held to
their final error (2 % relative) and factor dtypes."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _parity import interpret_pallas, np_  # noqa: F401  (fixture)
import pydnmfk_tpu
from pydnmfk_tpu.models import nmfk as jnmfk
from pydnmfk_tpu.models import sampler as js
from pydnmfk_tpu.models import updates as ju
from pydnmfk_tpu.ops import fused_kl as jfk
from pydnmfk_tpu.ops import fused_mu as jfm
from pydnmfk_tpu.ops import kl as jkl
from pydnmfk_tpu.ops import linalg as jl
from pydnmfk_tpu.utils.data_generator import generate_data
import pydnmfk_tpu_torch as port
from pydnmfk_tpu_torch.models import nmf as tnmf
from pydnmfk_tpu_torch.models import updates as tu
from pydnmfk_tpu_torch.ops import cuda_lib
from pydnmfk_tpu_torch.ops import fused_kl as tfk
from pydnmfk_tpu_torch.ops import fused_mu as tfm
from pydnmfk_tpu_torch.ops import kl as tkl
from pydnmfk_tpu_torch.ops import linalg as tl
from pydnmfk_tpu_torch.utils.convert import (as_tensor, config_from_jax,
                                             factors_from_numpy)
from pydnmfk_tpu_torch.utils.io import DataReader, DataWriter

HALF = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
        "float16": (jnp.float16, torch.float16)}
# a few ulps of each dtype, relative to the largest value
ULPS = {"bfloat16": 1e-2, "float16": 4e-3, "float32": 1e-5}


def _close(out, ref, rel, what=""):
    """out and ref agree to ``rel`` of ref's largest magnitude."""
    ref, out = np_(ref), np_(out)
    assert out.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * scale,
                               err_msg=what)


def _problem(seed, m=96, n=64, k=3, b=None, noise=0.1):
    """A planted rank-k matrix times (1 + noise U), so that fits floor at a
    few per cent, and U[0, 1) factors."""
    rng = np.random.default_rng(seed)
    _, _, X = generate_data(m, n, k, seed=seed)
    lead = () if b is None else (b,)
    A = X * (1.0 + noise * rng.random(lead + (m, n)))
    return A, rng.random(lead + (m, k)), rng.random(lead + (k, n))


def _pair(x, jdt, tdt):
    """x at a JAX dtype and the same values as a torch tensor."""
    xj = jnp.asarray(x, jdt)
    return xj, as_tensor(np.asarray(xj)).to(tdt)


@pytest.mark.parametrize("precision,a_precision",
                         [("bfloat16", "float16"), ("float16", "bfloat16")])
def test_one_half_dtype_for_a_and_the_other_for_the_factors_is_refused(
        tmp_path, precision, a_precision):
    """The JAX package's solve fails on this pair (its products promote the
    factors to f32 and its loop raises a TypeError); the port refuses it up
    front, for NMF, NMFk and the CLI alike."""
    A, W0, H0 = _problem(0, m=40, n=30)
    np.save(tmp_path / "X.npy", A.astype(np.float32))
    jcfg = pydnmfk_tpu.NMFConfig(k=3, itr=3, precision=precision,
                                 a_precision=a_precision)
    with pytest.raises(TypeError):
        pydnmfk_tpu.NMF(jcfg).fit(A.astype(np.float32), factors=(W0, H0))
    with pytest.raises(ValueError, match="half dtype"):
        port.NMFConfig(k=3, precision=precision, a_precision=a_precision)
    with pytest.raises(ValueError, match="half dtype"):
        config_from_jax(dataclasses.asdict(jcfg))
    from pydnmfk_tpu_torch import cli
    with pytest.raises(ValueError, match="half dtype"):
        cli.main(["--cpu", "--process=pyDNMF", "--p_r=1", "--p_c=1",
                  f"--precision={precision}", f"--a_precision={a_precision}",
                  f"--fpath={tmp_path}/", "--fname=X", "--ftype=npy",
                  "--k=3", "--itr=3", f"--results_path={tmp_path}/r/"])


@pytest.mark.parametrize("precision", ["bfloat16", "float16"])
@pytest.mark.parametrize("a_precision", ["float32", "float64"])
def test_an_a_wider_than_half_factors_is_refused(tmp_path, precision,
                                                 a_precision):
    """Half factors under an f32 or f64 A: the port refuses the pair up
    front (NMFConfig, hence NMFk, Runner, the CLI and config_from_jax),
    where its plain solve returned wide factors. For the f32 A the JAX
    package's solve raises a TypeError on the same inputs (its loop carries
    the half factors and gets f32 ones back); its f64 pairs are left out, as
    they would turn on x64 for the whole process."""
    with pytest.raises(ValueError, match="wider than its half factors"):
        port.NMFConfig(k=3, precision=precision, a_precision=a_precision)
    if a_precision == "float64":
        return
    A, W0, H0 = _problem(0, m=40, n=30)
    jcfg = pydnmfk_tpu.NMFConfig(k=3, itr=3, precision=precision,
                                 a_precision=a_precision)
    with pytest.raises(TypeError, match="carry"):
        pydnmfk_tpu.NMF(jcfg).fit(A.astype(np.float32), factors=(W0, H0))
    with pytest.raises(ValueError, match="wider than its half factors"):
        config_from_jax(dataclasses.asdict(jcfg))
    np.save(tmp_path / "X.npy", A.astype(np.float32))
    from pydnmfk_tpu_torch import cli
    with pytest.raises(ValueError, match="wider than its half factors"):
        cli.main(["--cpu", "--process=pyDNMF", "--p_r=1", "--p_c=1",
                  f"--precision={precision}", f"--a_precision={a_precision}",
                  f"--fpath={tmp_path}/", "--fname=X", "--ftype=npy",
                  "--k=3", "--itr=3", f"--results_path={tmp_path}/r/"])


@pytest.mark.parametrize("precision",
                         ["bfloat16", "float16", "float32", "float64"])
def test_eps_and_dtypes_match_jax(precision):
    """eps equals JAX's for each precision: bf16 takes f32's
    (pydnmfk_tpu/config.py:139-146), f16 its own 2^-10."""
    jcfg = pydnmfk_tpu.NMFConfig(precision=precision)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert cfg.eps == jcfg.eps
    assert cfg.dtype == getattr(torch, precision)
    if precision == "bfloat16":    # the other half dtype for A is refused
        with pytest.raises(ValueError, match="half dtype"):
            cfg.replace(a_precision="float16")
    else:
        assert cfg.replace(a_precision="float16").a_dtype == torch.float16


@pytest.mark.parametrize("case", ["bf16xbf16", "f16xf16", "u8xbf16",
                                  "u8xf16", "f16Axf32W", "f32Wxbf16A"])
def test_matmul_half_rules(case):
    """The dtype exactly; values to 1e-2 (bf16) and 2e-3 (f16) of the
    largest, against JAX (both sum exact products in f32)."""
    rng = np.random.default_rng(0)
    a, b = rng.random((40, 30)) * 3, rng.random((30, 6))
    jdt = {"bf16xbf16": (jnp.bfloat16, jnp.bfloat16),
           "f16xf16": (jnp.float16, jnp.float16),
           "u8xbf16": (jnp.uint8, jnp.bfloat16),
           "u8xf16": (jnp.uint8, jnp.float16),
           "f16Axf32W": (jnp.float16, jnp.float32),
           "f32Wxbf16A": (jnp.float32, jnp.bfloat16)}[case]
    if jdt[0] == jnp.uint8:
        a = np.round(a * 80)
    if case == "f32Wxbf16A":
        a, b = rng.random((6, 40)), rng.random((40, 30))
    aj, bj = jnp.asarray(a, jdt[0]), jnp.asarray(b, jdt[1])
    ref = jl.matmul(aj, bj)
    out = tl.matmul(as_tensor(np.asarray(aj)), as_tensor(np.asarray(bj)))
    assert str(out.dtype)[6:] == str(ref.dtype), (out.dtype, ref.dtype)
    narrow = "bfloat16" if jnp.bfloat16 in jdt else "float16"
    _close(out, ref, {"bfloat16": 1e-2, "float16": 2e-3}[narrow])


@pytest.mark.parametrize("precision", ["bfloat16", "float16"])
@pytest.mark.parametrize("chunk", [0, 24])
def test_norms_errors_and_quantize_at_half(precision, chunk):
    """relative_error, column_error, fro_norm, normalize_features and
    quantize_uint8 take half operands with f32 sums: errors to 1e-3
    relative (the direct residual is rounded to the half dtype in both
    packages, a slab's is not); normalized factors to a few ulps; Q exact."""
    jdt, tdt = HALF[precision]
    A, W, H = _problem(1)
    Aj, At = _pair(A, jdt, tdt)
    Wj, Wt = _pair(W, jdt, tdt)
    Hj, Ht = _pair(H, jdt, tdt)
    for name in ("relative_error", "column_error"):
        _close(getattr(tl, name)(At, Wt, Ht, chunk),
               getattr(jl, name)(Aj, Wj, Hj, chunk), 1e-3, name)
    _close(tl.fro_norm(Wt), jl.fro_norm(Wj), 1e-6)
    eps = pydnmfk_tpu.NMFConfig(precision=precision).eps
    (Wn, Hn), (Wnj, Hnj) = (tl.normalize_features(Wt, Ht, eps),
                            jl.normalize_features(Wj, Hj, eps))
    assert Wn.dtype == tdt and Hn.dtype == tdt
    _close(Wn, Wnj, ULPS[precision])
    _close(Hn, Hnj, ULPS[precision])
    Q, s = tl.quantize_uint8(At)
    Qj, sj = jl.quantize_uint8(Aj)
    np.testing.assert_array_equal(Q.numpy(), np.asarray(Qj))
    assert float(s) == float(sj)


STEPS = ["mu_fro", "mu_kl", "hals", "bcd1", "bcd2"]


def _steps(name, jax_pkg):
    mod = ju if jax_pkg else tu
    if name.startswith("bcd"):
        itr = int(name[3:])
        return lambda A, W, H, eps: mod.bcd_solve(A, W, H, eps, itr=itr)
    return getattr(mod, f"{name}_step")


@pytest.mark.parametrize("precision", ["bfloat16", "float16"])
@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("b", [None, 2])
def test_step_matches_jax(precision, step, b):
    """One MU-FRO, MU-KL or HALS step, and one or two BCD iterations, at
    half factors on an A of their dtype, single and as a stack of 2 (JAX's
    vmap): factors at the dtype, values to a few ulps of the largest
    (module docstring)."""
    jdt, tdt = HALF[precision]
    A, W, H = _problem(2, b=b)
    eps = pydnmfk_tpu.NMFConfig(precision=precision).eps
    Aj, At = _pair(A, jdt, tdt)
    Wj, Wt = _pair(W, jdt, tdt)
    Hj, Ht = _pair(H, jdt, tdt)
    fj = _steps(step, True)
    if b:
        fj = jax.vmap(fj, in_axes=(0, 0, 0, None))
    Wr, Hr = jax.jit(fj)(Aj, Wj, Hj, jnp.asarray(eps, jdt))
    Wo, Ho = _steps(step, False)(At, Wt, Ht, eps)
    assert Wo.dtype == tdt and Ho.dtype == tdt
    _close(Wo, Wr, 2 * ULPS[precision], "W")
    _close(Ho, Hr, 2 * ULPS[precision], "H")


# (A dtype, factor dtype) of the fused steps: an f16 A under f32 factors
# (a_precision="float16"), half factors on an A of their dtype or of the
# other half dtype, and a uint8 A under half factors
FUSED = [("float16", "float32"), ("bfloat16", "bfloat16"),
         ("float16", "float16"), ("uint8", "bfloat16"), ("uint8", "float16"),
         ("float16", "bfloat16"), ("bfloat16", "float16")]


def _fused_inputs(a_name, w_name, seed):
    A, W, H = _problem(seed, m=72, n=40)
    if a_name == "uint8":
        A = np.round(A / A.max() * 255)
    jdt = lambda nm: getattr(jnp, nm)
    tdt = lambda nm: getattr(torch, nm)
    return (_pair(A, jdt(a_name), tdt(a_name)),
            _pair(W, jdt(w_name), tdt(w_name)),
            _pair(H, jdt(w_name), tdt(w_name)),
            pydnmfk_tpu.NMFConfig(precision=w_name).eps)


@pytest.mark.parametrize("a_name,w_name", FUSED)
def test_fused_fro_step_matches_jax(a_name, w_name, interpret_pallas):
    """The K1 step (its plain version on the CPU) against JAX's fused step
    with its Pallas kernel in interpret mode: the operands rounded to the
    compute dtype (f16 for an f16 A, bf16 for a uint8 one), f32 sums, W'
    rounded once to the factor dtype: to a few ulps of the factor dtype."""
    (Aj, At), (Wj, Wt), (Hj, Ht), eps = _fused_inputs(a_name, w_name, 3)
    Wr, Hr = jfm.fused_mu_fro_step(Aj, Wj, Hj, jnp.asarray(eps, Wj.dtype))
    Wo, Ho = tfm.fused_mu_fro_step(At, Wt, Ht, eps)
    assert Wo.dtype == Wt.dtype and Ho.dtype == Ht.dtype
    tol = 2 * ULPS[w_name] if w_name != "float32" else 1e-5
    _close(Wo, Wr, tol, "W")
    _close(Ho, Hr, tol, "H")


@pytest.mark.parametrize("a_name,w_name", FUSED)
def test_fused_kl_step_matches_jax(a_name, w_name, interpret_pallas):
    """The K3 step (its plain version on the CPU) against JAX's fused step
    in interpret mode. The operands are bf16 for a uint8 or bf16 A in both;
    for an f16 A JAX rounds them to f16 and the port to bf16 (range,
    ops/fused_kl.py), so an f16 A is held to bf16's few ulps (1e-2), the
    rest to the factor dtype's."""
    (Aj, At), (Wj, Wt), (Hj, Ht), eps = _fused_inputs(a_name, w_name, 4)
    Wr, Hr = jfk.fused_mu_kl_step(Aj, Wj, Hj, jnp.asarray(eps, Wj.dtype))
    Wo, Ho = tfk.fused_mu_kl_step(At, Wt, Ht, eps)
    assert Wo.dtype == Wt.dtype and Ho.dtype == Ht.dtype
    tol = 2 * ULPS["bfloat16" if a_name == "float16" else w_name]
    _close(Wo, Wr, tol, "W")
    _close(Ho, Hr, tol, "H")


def test_f32_sums_restore_the_callers_settings():
    """The half products turn cuBLAS's reduced-precision reductions off only
    for their own calls: a caller's settings, either way, come back."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_bf16_reduced_precision_reduction,
             m.allow_fp16_reduced_precision_reduction)
    try:
        for flags in [(True, False), (False, True), (True, True)]:
            (m.allow_bf16_reduced_precision_reduction,
             m.allow_fp16_reduced_precision_reduction) = flags
            with tl.f32_sums():
                assert not m.allow_bf16_reduced_precision_reduction
                assert not m.allow_fp16_reduced_precision_reduction
            assert (m.allow_bf16_reduced_precision_reduction,
                    m.allow_fp16_reduced_precision_reduction) == flags
    finally:
        (m.allow_bf16_reduced_precision_reduction,
         m.allow_fp16_reduced_precision_reduction) = saved


@pytest.mark.parametrize("a_name", ["float32", "bfloat16", "float16",
                                    "uint8", "float64"])
@pytest.mark.parametrize("w_name", ["float32", "bfloat16", "float16"])
def test_kernel_pairs(a_name, w_name):
    """The (A, factor) dtype pairs the dense kernels take: every A but f64
    under f32 factors, and every A no wider than half factors (its own
    dtype, the other half dtype, uint8). Any other pair is refused by the
    kernels' operand check and takes the plain products; a pair the kernels
    take takes K3 for KL with ``use_fused`` (on the CPU, its plain
    version)."""
    a_dt, w_dt = getattr(torch, a_name), getattr(torch, w_name)
    takes = a_name != "float64" and (
        w_name == "float32" or a_name != "float32")
    assert cuda_lib.kernel_types(a_dt, w_dt) is takes
    A = torch.ones((16, 12), dtype=a_dt)
    W = torch.ones((16, 4), dtype=w_dt)
    if takes:
        cuda_lib.check_operands("K", A, {"W": W})
    else:
        with pytest.raises(TypeError, match="takes"):
            cuda_lib.check_operands("K", A, {"W": W})
    step = tnmf.step_for(A, W, "kl", True, 0, True)
    name = getattr(getattr(step, "func", step), "__qualname__")
    assert name == ("fused_mu_kl_step" if takes else "mu_kl_step")


@pytest.mark.parametrize("w_name", ["float32", "float16"])
@pytest.mark.parametrize("chunk", [0, 16])
def test_kl_plain_products_at_an_f16_a(w_name, chunk):
    """K2's plain versions on an f16 A, under f32 factors (the ratio and
    products f32: rtol 1e-5) and f16 factors (rounded like JAX's: a few
    f16 ulps), row-chunked or whole, against JAX's kl_uht / kl_wtu."""
    A, W, H = _problem(5, m=70, n=40)
    Aj, At = _pair(A, jnp.float16, torch.float16)
    Wj, Wt = _pair(W, getattr(jnp, w_name), getattr(torch, w_name))
    Hj, Ht = _pair(H, getattr(jnp, w_name), getattr(torch, w_name))
    eps = pydnmfk_tpu.NMFConfig(precision=w_name).eps
    tol = 1e-5 if w_name == "float32" else 2 * ULPS["float16"]
    for jf, tf in ((jkl.kl_uht, tkl.kl_uht), (jkl.kl_wtu, tkl.kl_wtu)):
        out = tf(At, Wt, Ht, eps, chunk)
        ref = jf(Aj, Wj, Hj, eps, chunk)
        assert str(out.dtype)[6:] == str(ref.dtype)
        _close(out, ref, tol, tf.__name__)


# fits: (precision, a_precision, norm, init)
FITS = [("bfloat16", None, "fro", "rand"), ("bfloat16", None, "kl", "rand"),
        ("float16", None, "fro", "rand"), ("float16", None, "kl", "rand"),
        ("bfloat16", None, "fro", "nnsvd"), ("float16", None, "kl", "nnsvd"),
        ("float32", "float16", "fro", "rand"),
        ("float32", "float16", "kl", "rand"),
        ("bfloat16", "uint8", "fro", "rand")]


@pytest.mark.parametrize("precision,a_precision,norm,init", FITS)
def test_fit_matches_jax(precision, a_precision, norm, init):
    """NMF.fit, 100 iterations from the same init (rand: the numpy factors
    fed to both; nnsvd: each package's own): the factors at the precision's
    dtype and the final error within 2 % relative of JAX's."""
    A, W0, H0 = _problem(6)
    jcfg = pydnmfk_tpu.NMFConfig(k=3, norm=norm, init=init, itr=100,
                                 precision=precision, a_precision=a_precision)
    kw = {} if init == "nnsvd" else {"factors": (W0, H0)}
    Wj, Hj, ej = pydnmfk_tpu.NMF(jcfg).fit(A.astype(np.float32), **kw)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    W, H, e = port.NMF(cfg, "cpu").fit(A.astype(np.float32), **kw)
    assert str(W.dtype)[6:] == str(Wj.dtype) == precision
    assert str(H.dtype)[6:] == str(Hj.dtype) == precision
    assert np.isfinite(e) and abs(e / ej - 1) < 0.02, (e, ej)


@pytest.mark.parametrize("precision", ["bfloat16", "float16"])
@pytest.mark.parametrize("method", ["hals", "bcd"])
def test_hals_bcd_fit_at_half_matches_jax(precision, method):
    """10 HALS or BCD iterations at half factors on a planted rank-16
    300x200 (U[0, 1) factors multiplied, as chip_smoke.py's A, scaled to
    [0, 1] for f16): the final error within 2 % of JAX's at the same
    precision, as the other fits. At bf16 HALS ends above its f32 error in
    both packages."""
    rng = np.random.default_rng(12)
    A = (rng.random((300, 16)) @ rng.random((16, 200))).astype(np.float32)
    if precision == "float16":
        A /= A.max()
    W0, H0 = rng.random((300, 16)), rng.random((16, 200))
    jcfg = pydnmfk_tpu.NMFConfig(k=16, norm="fro", method=method, itr=10,
                                 precision=precision)
    _, _, ej = pydnmfk_tpu.NMF(jcfg).fit(A, factors=(W0, H0))
    W, H, e = port.NMF(config_from_jax(dataclasses.asdict(jcfg)), "cpu").fit(
        A, factors=(W0, H0))
    assert W.dtype == H.dtype == getattr(torch, precision)
    assert abs(e / ej - 1) < 0.02, (e, ej)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hals_bf16_ends_as_far_from_f32_as_jax(seed):
    """The witness for chip_smoke.py's 5 % limit on HALS at bf16: 10 HALS
    iterations on a planted rank-32 1200x800 (U[0, 1) factors multiplied,
    as the smoke's A) from one U[0, 1) init, at f32 and at bf16 factors, in
    both packages. The JAX package's bf16 error lies more than 2 % above
    its f32 error (3.6-4.1 % for these seeds), below 5 %; the port's lies
    as far, to 0.01."""
    rng = np.random.default_rng(seed)
    A = (rng.random((1200, 32)) @ rng.random((32, 800))).astype(np.float32)
    W0, H0 = rng.random((1200, 32)), rng.random((32, 800))
    errs = {}
    for precision in ("float32", "bfloat16"):
        jcfg = pydnmfk_tpu.NMFConfig(k=32, norm="fro", method="hals", itr=10,
                                     precision=precision)
        _, _, ej = pydnmfk_tpu.NMF(jcfg).fit(A, factors=(W0, H0))
        _, _, e = port.NMF(config_from_jax(dataclasses.asdict(jcfg)),
                           "cpu").fit(A, factors=(W0, H0))
        errs[precision] = float(ej), float(e)
    gap_jax, gap_port = (errs["bfloat16"][i] / errs["float32"][i] - 1
                         for i in (0, 1))
    print(f"HALS bf16 over f32 after 10 iterations: JAX {gap_jax:.4f}, "
          f"port {gap_port:.4f}")
    assert 0.02 < gap_jax < 0.05, errs
    assert abs(gap_port - gap_jax) < 0.01, errs


def _jax_members(jcfg, A, k, sparse=False):
    """The perturbed copies (or nnz values) and rand inits the JAX per-k
    ensemble draws (nmfk.py:105-115, :232-276), for all members."""
    ncfg = jcfg.nmf.replace(k=k)
    keys = js.member_keys(jax.random.key(ncfg.seed), 0, jcfg.perturbations)
    data = A.data if sparse else A
    ens = jax.vmap(lambda kk: js.sample_member(
        data, js.member_noise_key(kk), jcfg.noise_var))(keys)
    if ens.dtype != jnp.dtype(ncfg.a_dtype):
        ens = ens.astype(ncfg.a_dtype)
    W0, H0 = jnmfk._draw_init_factors(ncfg, keys, None, None, *A.shape)
    return np.asarray(ens), np.asarray(W0), np.asarray(H0)


def _walk(stats, ks, sill_thr):
    """The reference's Wilcoxon walk (pyDNMFk.py:260-300, JAX
    ``nmfk.py::pvalue_analysis``) over per-k statistics held in memory."""
    from scipy.stats import wilcoxon
    sill_min = [round(float(np.min(np.asarray(
        stats[k]["clusterSilhouetteCoefficients"], np.float32))), 2)
        for k in ks]
    errs = [np.asarray(stats[k]["L_err"], np.float64) for k in ks]
    best, nopt = errs[0], 1
    for i in range(1, len(ks)):
        if sill_min[i - 1] > sill_thr:
            try:
                p = wilcoxon(best, errs[i])[1]
            except ValueError:
                p = 1.0
            if p < 0.05:
                nopt, best = i, errs[i]
    return ks[nopt - 1]


@pytest.mark.parametrize("precision", ["bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["dense-fro", "dense-kl", "sparse-fro"])
def test_nmfk_sweep_matches_jax(tmp_path, precision, kind):
    """The NMFk sweep at half factors, the port fed the JAX package's member
    draws: the same k, and per-k minimum and mean silhouettes (taken in f32)
    within 0.1 of JAX's. The member factors drift apart over the solve
    (module docstring), so the clusterings agree in their statistics, and
    the silhouettes, rounded to bf16 (0.0039 near 1) in both packages, move
    with them: by up to 0.05 at k = 2 below the planted k = 3."""
    from jax.experimental import sparse as jsparse
    from test_torch_nmfk import _planted_sparse, _triplet
    norm = kind.split("-")[1]
    sparse = kind.startswith("sparse")
    X = (_planted_sparse() if sparse
         else generate_data(m=64, n=48, k=3, seed=100)[2])
    jcfg = pydnmfk_tpu.NMFkConfig(
        nmf=pydnmfk_tpu.NMFConfig(itr=150, norm=norm, precision=precision,
                                  seed=42),
        start_k=2, end_k=4, perturbations=5, sill_thr=0.6,
        results_path=str(tmp_path / "jax") + "/", fname="h",
        checkpoint=False, k_sweep_batch=False)
    jdt = jcfg.nmf.dtype
    Aj = (jsparse.BCOO.fromdense(jnp.asarray(X, jdt)) if sparse
          else jnp.asarray(X, jdt))
    jm = pydnmfk_tpu.NMFk(jcfg)
    try:
        nopt_jax = jm.fit(Aj)
    except TypeError:
        # the JAX package's walk reads its bf16 silhouettes back from
        # results.h5, where h5py stores them as opaque 2-byte records
        # (ROADMAP queue 3): its choice, from the stats it recorded
        assert precision == "bfloat16"
        nopt_jax = _walk(jm.per_k_stats, list(jcfg.k_range), jcfg.sill_thr)
    model = port.NMFk(config_from_jax(dataclasses.asdict(jcfg.replace(
        results_path=str(tmp_path / "torch") + "/"))), "cpu")
    os.makedirs(model.results_path)
    At = model._prepare(_triplet(X) if sparse else X)
    for k in jcfg.k_range:
        members = _jax_members(jcfg, Aj, k, sparse)
        ens = model._solve_ensemble(At, k, members=members)
        assert ens[0].dtype == getattr(torch, precision)
        stats = model.pynmfk_per_k(At, k, ensemble=ens)
        ref = jm.per_k_stats[k]
        sils = np.asarray(stats["clusterSilhouetteCoefficients"], np.float32)
        sref = np.asarray(ref["clusterSilhouetteCoefficients"], np.float32)
        assert abs(sils.min() - sref.min()) < 0.1, (k, sils, sref)
        assert abs(sils.mean() - sref.mean()) < 0.1, (k, sils, sref)
    assert model.pvalue_analysis() == nopt_jax == 3


@pytest.mark.parametrize("precision", ["bfloat16", "float16"])
@pytest.mark.parametrize("ftype", ["npy", "npz"])
def test_reader_at_half_precisions(tmp_path, precision, ftype):
    """DataReader at bfloat16 (read at f32, rounded by torch) and float16
    gives JAX's reader's values, dense and sparse."""
    from pydnmfk_tpu.utils.io import DataReader as JaxReader
    from scipy import sparse as sp
    X = _problem(7, m=20, n=12)[0] * (np.arange(12) % 3 > 0)
    if ftype == "npy":
        np.save(tmp_path / "X.npy", X)
    else:
        sp.save_npz(tmp_path / "X.npz", sp.csr_matrix(X))
    out = DataReader(f"{tmp_path}/", "X", ftype, precision).read()
    jr = JaxReader(f"{tmp_path}/", "X", ftype, precision=precision)
    ref = jr.read_global()
    if ftype == "npz":
        assert out.data.dtype == getattr(torch, precision)
        out = out.data
        ref = ref.sort_indices().data
    assert str(as_tensor(out).dtype)[6:] == precision
    np.testing.assert_array_equal(np_(as_tensor(out)),
                                  np.asarray(ref, np.float64))


@pytest.mark.parametrize("precision,saved", [("bfloat16", np.float32),
                                             ("float16", np.float16),
                                             ("float32", np.float32)])
def test_writers_save_half_factors(tmp_path, precision, saved):
    """bf16 factors are saved widened to f32 (exact; .npy has no bf16), f16
    ones as f16."""
    W, H = factors_from_numpy(*_problem(8, m=10, n=6)[1:], "cpu",
                              getattr(torch, precision))
    DataWriter(str(tmp_path)).save_factors(W, H)
    Ws = np.load(tmp_path / "W_factors" / "W.npy")
    Hs = np.load(tmp_path / "H_factors" / "H.npy")
    assert Ws.dtype == saved and Hs.dtype == saved
    np.testing.assert_array_equal(Ws, np_(W))
    np.testing.assert_array_equal(Hs, np_(H))


def test_bf16_numpy_arrays_convert_exactly():
    """numpy.asarray of a JAX bf16 array has ml_dtypes' bfloat16, which
    torch.as_tensor rejects: as_tensor and factors_from_numpy take it."""
    x = np.asarray(jnp.asarray(np.random.default_rng(9).random((5, 4)),
                               jnp.bfloat16))
    assert x.dtype == ml_dtypes.bfloat16
    t = as_tensor(x)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))
    W, H = factors_from_numpy(x, x.T, "cpu", torch.bfloat16)
    assert torch.equal(W, t) and torch.equal(H, t.mT)


def _sweep_stats(tmp_path, tag, **kw):
    _, _, X = generate_data(m=48, n=36, k=3, seed=100)
    cfg = port.NMFkConfig(
        nmf=port.NMFConfig(itr=120, norm="kl", precision="float64"),
        start_k=2, end_k=4, perturbations=7,
        results_path=str(tmp_path / tag) + "/", fname="b", checkpoint=False,
        **kw)
    model = port.NMFk(cfg, "cpu")
    nopt = model.fit(X)
    return model, nopt


def test_hbm_budget_batches_give_the_whole_ensemble(tmp_path, monkeypatch):
    """A budget that holds 3 of 7 members solves the ensemble in batches
    (3, 3, 1) with the results of one batch of all 7: each member draws from
    its own generator, so only the batching differs (f64, rtol 1e-12). The
    PYDNMFK_HBM_BUDGET variable does the same where hbm_budget is 0."""
    whole, nopt = _sweep_stats(tmp_path, "whole")
    assert whole.last_batch_size == 7
    m, n, k = 48, 36, 4
    per_member = m * n * 8 + m * n * 4 + (m + n) * k * 8 * 8
    budget = int((3.5 * per_member + m * n * 8) / 0.85)
    cut, nopt_cut = _sweep_stats(tmp_path, "cut", hbm_budget=budget)
    assert cut.last_batch_size == 3 and nopt_cut == nopt
    for kk in range(2, 5):
        for key in ("recon_err", "L_err", "clusterSilhouetteCoefficients"):
            np.testing.assert_allclose(cut.per_k_stats[kk][key],
                                       whole.per_k_stats[kk][key],
                                       rtol=1e-12, atol=1e-14)
    monkeypatch.setenv("PYDNMFK_HBM_BUDGET", str(budget))
    env, _ = _sweep_stats(tmp_path, "env")
    assert env.last_batch_size == 3


@pytest.mark.parametrize("norm", ["kl"])
@pytest.mark.parametrize("kl_chunk", [8, 40, 1000])
def test_kl_chunk_gives_the_unchunked_fit(norm, kl_chunk):
    """kl_chunk > 0 bounds the plain KL products' ratio slab; only the
    summation order of W^T U changes: the fit equals the unchunked one to
    f64 rounding, as in JAX (nmf.py:238-242)."""
    A, W0, H0 = _problem(10, m=70, n=30)
    base = port.NMFConfig(k=3, norm=norm, itr=30, precision="float64")
    W, H, e = port.NMF(base, "cpu").fit(A, factors=(W0, H0))
    Wc, Hc, ec = port.NMF(base.replace(kl_chunk=kl_chunk), "cpu").fit(
        A, factors=(W0, H0))
    np.testing.assert_allclose(np_(Wc), np_(W), rtol=1e-10)
    np.testing.assert_allclose(np_(Hc), np_(H), rtol=1e-10)
    assert abs(ec - e) < 1e-12
    jcfg = pydnmfk_tpu.NMFConfig(k=3, norm=norm, itr=30, kl_chunk=kl_chunk)
    assert config_from_jax(dataclasses.asdict(jcfg)).kl_chunk == kl_chunk


def test_cli_runs_the_half_precisions_and_knobs(tmp_path):
    """--precision=bfloat16|float16, --a_precision=float16, --hbm_budget and
    --kl_chunk pass through the CLI to NMF and NMFk."""
    from pydnmfk_tpu_torch import cli
    A = _problem(11, m=40, n=30)[0]
    np.save(tmp_path / "X.npy", A.astype(np.float32))
    common = ["--p_r=1", "--p_c=1", "--cpu", "--ftype=npy",
              f"--fpath={tmp_path}/", "--fname=X", "--k=3", "--itr=40",
              f"--results_path={tmp_path}/res/"]
    for flags, dtype in ((["--precision=bfloat16"], torch.bfloat16),
                         (["--precision=float16", "--kl_chunk=8"],
                          torch.float16),
                         (["--a_precision=float16"], torch.float32)):
        out = cli.main(["--process=pyDNMF", "--norm=kl", *common, *flags])
        assert out["W"].dtype == dtype and np.isfinite(out["err"])
        assert out["err"] < 0.2
    out = cli.main(["--process=pyDNMFk", "--norm=fro", *common,
                    "--precision=bfloat16", "--start_k=2", "--end_k=3",
                    "--perturbations=4", "--hbm_budget=200000"])
    assert out["nopt"] in (2, 3)


def test_f16_clustering_eps_matches_jax():
    """At f16 the clustering normalizes W's columns by sqrt(sum of squares
    + eps) with f16's eps, 9.8e-4 (JAX clustering.py:37-44, nmfk.py:1246):
    where a column's unit L1 mass spreads over more rows than about 1 / eps,
    the columns stay short of unit length and the silhouettes collapse.
    The port keeps that semantics: on an ensemble of spread columns both
    packages give the same collapsed silhouettes (to 1e-2), far below the
    ones at f32's eps."""
    from pydnmfk_tpu.models import clustering as jc
    from pydnmfk_tpu_torch.models import clustering as tc
    rng = np.random.default_rng(13)
    W, _, _ = generate_data(1500, 10, 2)
    W_all = np.stack([W * (1 + 0.05 * rng.random(W.shape)) for _ in range(6)])
    W_all = W_all / W_all.sum(1, keepdims=True)          # unit L1 columns
    H_all = rng.random((6, 2, 10))
    eps16 = pydnmfk_tpu.NMFConfig(precision="float16").eps
    Wj, Hj = (jnp.asarray(x, jnp.float16) for x in (W_all, H_all))
    Wt, Ht = (torch.from_numpy(x).half() for x in (W_all, H_all))
    for eps, lo, hi in ((eps16, 0.0, 0.5), (1.19e-7, 0.9, 1.0)):
        ref = np.asarray(jc.cluster_ensemble(Wj, Hj, eps)[3], np.float32)
        out = np_(tc.cluster_ensemble(Wt, Ht, eps)[3])
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-2)
        assert lo <= ref.min() and ref.max() <= hi, (eps, ref)
