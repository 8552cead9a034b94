"""The least times of work.py against hand counts."""
import pytest

from nmf_bench import work

M, N, K = 57600, 38400, 32
A_BYTES = M * N * 4


def test_fro_iteration_is_one_read_of_a():
    # 4 m n k = 283 GFLOP at 165 TFLOP/s is 1.72 ms; A's 8.85 GB and the
    # factors' 24.6 MB at 3.35 TB/s 2.648 ms: bytes bound
    want = (A_BYTES + 2 * (M + N) * K * 4) / 3.35e12
    assert work.iteration_s("fro", M, N, K) == pytest.approx(want, rel=1e-12)
    assert work.iteration_s("fro", M, N, K) == pytest.approx(2.64e-3,
                                                             rel=5e-3)


def test_kl_iteration_is_bound_by_operations():
    # 8 m n k = 566 GFLOP at 165 TFLOP/s: 3.43 ms
    assert work.iteration_s("kl", M, N, K) == pytest.approx(
        8 * M * N * K / 165e12, rel=1e-12)
    assert work.iteration_s("kl", M, N, K) == pytest.approx(3.43e-3,
                                                            rel=5e-3)


def test_member_stack_reads_every_member():
    m, n = 14400, 9600
    want = 10 * (m * n + 2 * (m + n) * 8) * 4 / 3.35e12
    assert work.iteration_s("fro", m, n, 8, members=10) == pytest.approx(
        want, rel=1e-12)
    assert work.iteration_s("fro", m, n, 8, members=10) == pytest.approx(
        1.65e-3, rel=5e-3)


def test_w_frozen_iteration_halves_the_products():
    m, n, k = 14400, 9600, 7
    assert work.iteration_s("kl", m, n, k, w_update=False) == pytest.approx(
        (m * n + 2 * n * k) * 4 / 3.35e12, rel=1e-12)


def test_solve_and_sweep_add_up():
    fit = work.solve_s("fro", M, N, K, 10)
    assert fit == pytest.approx(10 * work.iteration_s("fro", M, N, K)
                                + work.error_s(M, N, K), rel=1e-12)
    assert work.error_s(M, N, K) == pytest.approx(
        (A_BYTES + (M + N) * K * 4) / 3.35e12, rel=1e-12)
    m, n, p, itr = 14400, 9600, 10, 400
    one_k = (work.sample_s(m, n, p) + itr * work.iteration_s("fro", m, n, 3, p)
             + work.error_s(m, n, 3, p)
             + itr * work.iteration_s("fro", m, n, 3, 1, w_update=False)
             + 2 * work.error_s(m, n, 3))
    assert work.sweep_s("fro", m, n, [3], p, itr) == pytest.approx(one_k)
    assert work.sample_s(m, n, p) == pytest.approx(11 * m * n * 4 / 3.35e12)
