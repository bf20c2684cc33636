"""The port's analytic scaling model (``distkeras_tpu_torch/roofline.py``)
held to the JAX package's arithmetic: with the reference's link constants
passed in, every curve is the reference's to the last bit; with the
port's defaults it uses the H100's NVLink and InfiniBand spec figures."""

import pytest

from distkeras_tpu import roofline as ref
from distkeras_tpu_torch import roofline as port

#: the reference's v5e figures, passed in explicitly
V5E = dict(ici_bytes_per_s=ref.ICI_LINK_BYTES_PER_S,
           dcn_bytes_per_s=ref.DCN_BYTES_PER_S,
           chips_per_slice=256, chips_per_host=8)


@pytest.mark.parametrize("nbytes,n", [(1e6, 1), (1e8, 2), (1e8, 64),
                                      (1e8, 256), (3.3e7, 7)])
def test_allreduce_seconds_is_the_reference_arithmetic(nbytes, n):
    for link in (ref.ICI_LINK_BYTES_PER_S, ref.DCN_BYTES_PER_S):
        assert port.allreduce_seconds(nbytes, n, link) == \
            ref.allreduce_seconds(nbytes, n, link)
    assert port.allreduce_seconds(nbytes, n) == \
        ref.allreduce_seconds(nbytes, n, port.NVLINK_BYTES_PER_S)


def test_allreduce_seconds_shape():
    assert port.allreduce_seconds(1e6, 1) == 0.0
    t64 = port.allreduce_seconds(1e8, 64)
    t256 = port.allreduce_seconds(1e8, 256)
    assert t64 < t256 < 2 * 1e8 / port.NVLINK_BYTES_PER_S


@pytest.mark.parametrize("kw", [
    dict(round_seconds=0.03, model_bytes=6e6),
    dict(round_seconds=0.01, model_bytes=1e8),
    dict(round_seconds=0.02, model_bytes=1e8,
         link_bytes_per_s=ref.DCN_BYTES_PER_S),
])
def test_fold_curve_is_the_reference_s(kw):
    kw = {"link_bytes_per_s": ref.ICI_LINK_BYTES_PER_S, **kw}
    assert port.FoldScalingModel(**kw).curve() == \
        ref.FoldScalingModel(**kw).curve()


def test_fold_curve_is_monotone_and_the_window_trades():
    m = port.FoldScalingModel(round_seconds=0.03, model_bytes=6e6)
    effs = [p["efficiency"] for p in m.curve()]
    assert all(0 < e <= 1 for e in effs)
    assert all(a >= b for a, b in zip(effs, effs[1:]))
    base = port.FoldScalingModel(round_seconds=0.01, model_bytes=1e8)
    wider = port.FoldScalingModel(round_seconds=0.02, model_bytes=1e8)
    assert wider.efficiency(64) > base.efficiency(64)
    ib = port.FoldScalingModel(round_seconds=0.02, model_bytes=1e8,
                               link_bytes_per_s=port.IB_BYTES_PER_S)
    assert ib.efficiency(64) < wider.efficiency(64)


def _resnet(mod, **kw):
    # config #5's step from the reference test's pinned fallback figure
    return mod.SyncStepScalingModel(step_seconds=128 / 1980.4,
                                    grad_bytes=4 * 25.6e6, **kw)


@pytest.mark.parametrize("extra", [{}, {"chips_per_slice": 128},
                                   {"grad_accum": 4}])
def test_sync_step_model_is_the_reference_s(extra):
    kw = {**V5E, **extra}
    mine, theirs = _resnet(port, **kw), _resnet(ref, **kw)
    assert mine.curve() == theirs.curve()
    for n in (1, 64, 128, 256, 512):
        assert mine.comm_seconds(n) == theirs.comm_seconds(n)


def test_sync_step_model_levers_and_hop():
    single = _resnet(port, **V5E)
    multi = _resnet(port, **{**V5E, "chips_per_slice": 128})
    assert multi.comm_seconds(256) > single.comm_seconds(256)
    assert multi.comm_seconds(128) == single.comm_seconds(128)
    bf16 = _resnet(port, **V5E)
    bf16.grad_bytes /= 2
    assert bf16.comm_seconds(256) == pytest.approx(
        single.comm_seconds(256) / 2)
    assert _resnet(port, **V5E, grad_accum=4).efficiency(256) > \
        single.efficiency(256)


def test_h100_defaults_cross_infiniband_past_one_board():
    m = _resnet(port)
    assert m.chips_per_slice == port.NVLINK_DOMAIN == 8
    assert m.ici_bytes_per_s == 450e9 and m.dcn_bytes_per_s == 50e9
    # inside the board: NVLink only
    assert m.comm_seconds(8) == port.allreduce_seconds(
        m.grad_bytes, 8, 450e9)
    # past it the InfiniBand hop adds 2 * (S/8) * (slices-1)/slices / 50e9
    hop = 2.0 * (m.grad_bytes / 8) * (2 - 1) / 2 / 50e9
    assert m.comm_seconds(16) == pytest.approx(m.comm_seconds(8) + hop)
