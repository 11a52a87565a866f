"""msm_roofline: the least time of the timed pass's MSMs (Pippenger's
least work for each MSM's point count at the card's IMAD peak,
`msm_work.py`, `peaks.json`) over the device's busy time inside those MSM
calls (the union of the profiler's device events within each call's
synchronised interval), in %.  Host gaps inside the calls do not count."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import msm_work  # noqa: E402


def read(rec):
    t = rec.get("timed")
    peak = rec.get("peaks")
    if not t or not peak or not t["msm_device_s"] or not t["msm_points"]:
        return None
    routes = sum(v for k, v in t["msm_routes"].items() if k != "small_batches")
    if routes != len(t["msm_points"]):
        return None
    least = sum(msm_work.least_seconds(n, peak) for n in t["msm_points"])
    return 100.0 * least / t["msm_device_s"]
