"""The yardstick's counts against counts worked out by hand at small
shapes."""
import pytest

from benchmark.counts import triangular, work


def test_render_core_forward_by_hand():
    # R=2 rays of S=3 samples, K=4 draws, F=1 step, test mode:
    # inputs 4*K + B*(24F+2) floats, outputs 3RK + 2RK + 2R; 32F + 33 a (point, draw)
    B = 6
    nbytes, ops = work.render_core_work(2, 3, 4, 1, False)
    assert nbytes == 4 * (16 + B * 26 + (24 + 16 + 4))
    assert ops == B * 4 * (32 + 33)
    _, ops_train = work.render_core_work(2, 3, 4, 1, True)
    assert ops_train == B * 4 * (32 + 33 + 36 + 26)


def test_render_core_backward_by_hand():
    B, K, F = 6, 4, 2
    nbytes, ops = work.render_core_bwd_work(2, 3, K, F, True)
    assert ops == B * K * (32 * F + 24 + 89 * F + 42 + 65 * F + 15)
    assert nbytes == 4 * ((K * 4 + B * (24 * F + 2) + 2 * 3 * K + 2 * 2 * K + 2 * 2)
                          + (K * 4 + B * 24 * F))


@pytest.mark.parametrize("Z", [1, 3])
def test_flow_stack_by_hand(Z):
    B, K, F = 5, 2, 3
    nbytes, ops = work.flow_stack_work(B, K, Z, F, False)
    assert ops == B * K * F * (2 * Z * (Z + 1) + Z)
    assert nbytes == 4 * (K * Z + B * (2 * Z * Z * F + Z * F) + B * K * Z + B * K)
    _, bwd = work.flow_stack_bwd_work(B, K, Z, F, True)
    assert bwd == B * K * (F * (2 * Z * (Z + 1) + Z) + F * (5 * Z * (Z + 1) + 5 * Z + 16 * Z))


def test_trunk_by_hand():
    # D3/W4, 2 input and 1 view channels, heads 2 and 3, B = 10 rows
    macs = 2 * 4 + 1 * 4 * 4 + (2 + 4) * 4 + 4 * 4 + 4 * 2 + (4 + 1) * 2 + 2 * 3
    nbytes, ops = work.trunk_work(10, 3, 4, 2, 1, 2, 3)
    assert ops == 2 * macs * 10
    assert nbytes == 4 * 10 * 3 + 2 * macs + 4 * (3 * 4 + 4 + 2 + 2 + 3) + 4 * 10 * 5
    _, bwd = work.trunk_bwd_work(10, 3, 4, 2, 1, 2, 3)
    assert bwd == 2 * (macs + macs - 2 * 2 * 4 - 1 * 2) * 10


def test_model_ops_sum_their_parts():
    flags = dict(netdepth=3, netwidth=4, netdepth_fine=3, netwidth_fine=4, multires=0,
                 multires_views=0, h_alpha_size=2, h_rgb_size=2, n_flows=1, K_samples=2,
                 N_samples=3, N_importance=0)
    trunk = work.trunk_work(3, 3, 4, 3, 3, 2, 2)[1]
    amor = 2 * 3 * (2 * 1 * 4 + 2 * 1 * 18)  # density 1 + 3, rgb 9 + 9 outputs a step
    core = work.render_core_work(1, 3, 2, 1, False)[1]
    assert triangular.model_ops(flags, 1, False) == trunk + amor + core
    hier = dict(flags, N_importance=2)
    coarse, fine = 3, 5
    expect = (work.trunk_work(coarse, 3, 4, 3, 3, 2, 2)[1] + work.trunk_work(fine, 3, 4, 3, 3, 2, 2)[1]
              + 2 * (coarse + fine) * (2 * 4 + 2 * 18)
              + sum(work.flow_stack_work(b, 2, z, 1, False)[1] for b in (coarse, fine) for z in (1, 3))
              + (coarse + fine) * 2 * triangular.COMPOSITE_OPS)
    assert triangular.model_ops(hier, 1, False) == expect


def test_bound_is_the_larger_of_the_two():
    ms, by = work.bound_ms(3.35e9, 1.0)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = work.bound_ms(1.0, 67e9)
    assert ms == pytest.approx(1.0) and by == "operations"
