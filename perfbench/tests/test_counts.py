"""The operation and byte counts on hand-counted shapes."""

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
