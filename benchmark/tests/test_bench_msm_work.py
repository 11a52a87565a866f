"""The MSM least-work count against hand counts."""

import msm_work
from registry import Registry


def test_least_adds_by_hand():
    # n = 1: c = 2 gives 127 windows x (1 + 4) = 635; c = 1: 254 x 3 = 762,
    # c = 3: 85 x 9 = 765
    assert msm_work.least_adds(1) == 635
    # n = 2^16: c = 13 gives 20 x (65536 + 8192) = 1,474,560; c = 12:
    # 22 x 69,632 = 1,531,904; c = 14: 19 x 81,920 = 1,556,480
    assert msm_work.least_adds(1 << 16) == 1_474_560
    assert msm_work.least_adds(0) == 0


def test_least_seconds_at_2e22_points():
    peak = Registry().peaks("NVIDIA H100 80GB HBM3")
    # c = 17: 15 x (2^22 + 2^17) = 64,880,640 adds (c = 16: 16 x 4,259,840
    # = 68,157,440; c = 18: 15 x 4,456,448 = 66,846,720), x 11 x 264 IMADs
    # over 64 x 132 x 1.98e9 IMADs a second
    assert msm_work.least_adds(1 << 22) == 64_880_640
    want = 64_880_640 * 11 * 264 / (64 * 132 * 1.98e9)
    assert abs(msm_work.least_seconds(1 << 22, peak) - want) < 1e-12
    assert 0.011 < want < 0.012
