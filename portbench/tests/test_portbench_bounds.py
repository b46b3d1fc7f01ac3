"""The bound arithmetic against counts made by hand."""
import pytest

from portbench import bounds


def test_btd_flops_by_hand():
    # One block of 1: a Cholesky (1/3) and two solves (2).
    assert bounds.btd_flops(1, 1) == pytest.approx(1 / 3 + 2)
    # Two blocks of 2: 2 (8/3 + 8) for the blocks, (16 + 16) for the one
    # coupling.
    assert bounds.btd_flops(2, 2) == pytest.approx(2 * (8 / 3 + 8) + 32)
    # The 2-D cell: 101 blocks of 4.
    assert bounds.btd_flops(101, 4) == pytest.approx(
        101 * (64 / 3 + 32) + 100 * (128 + 64))


def test_btd_bytes_and_bound_by_hand():
    # B=2048, 101 blocks of 4 in float32: diag 2048·101·16, off 2048·100·16,
    # rhs and x 2·2048·101·4 elements of 4 bytes.
    want = 4 * (2048 * 101 * 16 + 2048 * 100 * 16 + 2 * 2048 * 101 * 4)
    assert bounds.btd_bytes(2048, 101, 4) == want
    t = bounds.btd_bound_s(2048, 101, 4)
    assert t == pytest.approx(max(want / 3.35e12,
                                  2048 * bounds.btd_flops(101, 4) / 67e12))
    assert t == pytest.approx(want / 3.35e12)  # bytes bind at D = 4


def test_gn_iteration_by_hand():
    # Per state: 20 (lookup) + 4·16 + 2·16 + 2·4 + 2·16 + 4 = 160.
    assert bounds.gn_iter_flops(100, 4) == pytest.approx(
        bounds.btd_flops(101, 4) + 101 * 160)
    # Trajectory read and written (4 floats a state), 4 taps a state, one
    # error a problem.
    assert bounds.gn_iter_bytes(2, 100, 4) == 4 * (202 * 4 + 4 * 202
                                                   + 202 * 4 + 2)


def test_bound_takes_the_larger_side():
    assert bounds.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert bounds.bound_s(0.0, 67e12) == pytest.approx(1.0)
    assert bounds.bound_s(0.0, 67e12, "float64") == pytest.approx(1.0)
