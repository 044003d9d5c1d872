"""The operation and byte counts on hand-counted shapes."""

import pytest

from perfbench import counts


def test_lbs_counts_by_hand():
    # B=2 lanes, V=3 vertices, J=2 joints, 4 nonzero weights:
    # ops 2*2*4*12 + 18*2*3 = 192 + 108; bytes 4*(2*2*16 + 2*2*3*3) + 8*4.
    assert counts.lbs_counts(2, 3, 2, 4) == (300.0, 4.0 * (64 + 36) + 32.0)


def test_scatter_counts_by_hand():
    # B=1, R=4 rows of C=3 into 5 rows: 12 adds; 4*4 id bytes,
    # 4*3*(4 + 5) value and output bytes.
    assert counts.scatter_counts(1, 4, 3, 5) == (12.0, 16.0 + 108.0)


def test_least_time_takes_the_larger_bound():
    pk = {"fp32_flops": 10.0, "hbm_bytes": 100.0}
    assert counts.least_s(50.0, 100.0, pk) == 5.0
    assert counts.least_s(5.0, 1000.0, pk) == 10.0


def test_forward_flops_by_hand():
    # V=1, J=1, P=1, 1 coefficient, 1 weight, 1 regressor entry, no
    # landmarks or keypoints: 6 + 6 + 6 + 128 + (24 + 18).
    assert counts.forward_flops(1, 1, 1, 1, 1, 1, 0, 0) == 188.0
    assert counts.joints_flops(1, 1, 1, 1, 1, 0, 0) == 188.0


def test_peaks_are_the_published_h100_sxm_rates():
    pk = counts.peak("NVIDIA H100 80GB HBM3")
    assert pk == {"fp32_flops": 67e12, "hbm_bytes": 3.35e12}
    assert counts.peak("a card with no published row") is None


def test_vposer_flops_by_hand():
    # latent 1, hidden 2, 1 joint (6 outputs): products 2*(2 + 4 + 12) =
    # 36, biases 2 + 2 + 6, leaky 4, Gram-Schmidt and log map 38 + 19.
    assert counts.vposer_flops(1, 2, 1) == 36.0 + 10 + 4 + 57
    # the published widths: ~0.69 MFLOP a lane
    assert 0.68e6 < counts.vposer_flops(32, 512, 21) < 0.70e6


def _run(vposer):
    import numpy as np
    from types import SimpleNamespace

    shapes = dict(V=10, J=2, P=9, coeffs=3, nnz_w=20, nnz_jreg=6, S=4,
                  nnz_sub=8, landmarks=1, keypoints=5, both_orient=True,
                  coll_stages=[False, True])
    if vposer is not False:
        shapes["vposer"] = vposer
    fit = dict(camera_evals=np.array([3, 5]),
               stage_evals=np.array([[4, 6], [7, 1]]), seconds=2.0)
    return SimpleNamespace(peak={"fp32_flops": 1e6}, untraced=[fit, fit],
                           shapes=shapes)


def test_fit_mfu_counts_the_decoder_only_under_vposer():
    from perfbench.metrics.fit_mfu import read

    plain = read(_run(False))
    assert read(_run(None)) == plain
    vp = dict(latent=1, hidden=2, joints=1)
    dec = counts.vposer_flops(**vp)
    # per fit: the camera guess and the recovered meshes (2 lanes each),
    # camera evaluations 8 and body ones 18 over both orientations, each
    # with its gradient
    per_fit = dec * (2 + 2 * 8 + 2 * 2 * 18 + 2)
    extra = 100.0 * 2 * per_fit / (4.0 * 1e6)
    assert read(_run(vp)) == pytest.approx(plain + extra, rel=1e-12)
