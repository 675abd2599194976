"""The frozen counts of ``roofline.py`` at the shapes the port's chip
smoke measured, worked out by hand here: 132 SMs, 1,980 MHz."""

import pytest

from benchmark import roofline

SMS, CLOCK = 132, 1.98e9


def test_sw_cigar_bound_at_the_smoke_shape():
    # 16,384 lanes x 151 rows x 128 cells x 19 instructions over
    # 132 x 128 lanes at 1,980 MHz; the bytes take 0.0121 ms
    rows = 16384 * 151
    want = rows * 128 * 19 / (132 * 128) / 1.98e9 * 1e3
    got = roofline.sw_cigar_ms(16384, 151, 256, rows, CLOCK, SMS)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(0.17985, abs=5e-5)
    # the smoke's 0.1613 ms: that launch's lanes ran 135.5 rows each
    assert roofline.sw_cigar_ms(16384, 151, 256, int(16384 * 135.5),
                                CLOCK, SMS) == pytest.approx(0.1613, abs=2e-4)


def test_sw_unbanded_bound_at_vars_call():
    # var's largest scan call: 222 lanes x 150 rows x 192 columns x 8
    got = roofline.sw_unbanded_score_ms(222, 150, 192, 222 * 150, CLOCK,
                                        SMS)
    assert got == pytest.approx(0.001529, rel=2e-3)


def test_a_bound_of_few_operations_is_its_bytes():
    nbytes = 4.0 * (10 * 151 + 10 + 10 * 256 + 10 * (9 + 96))
    got = roofline.sw_cigar_ms(10, 151, 256, 10, CLOCK, SMS)
    assert got == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert roofline.INT32_ISSUE_PER_SM == 128
    assert roofline.HBM_BYTES_PER_S == 3.35e12
