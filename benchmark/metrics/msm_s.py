"""msm_s: the engine's `msm` and `msm_many` calls in the timed pass of a
traced run (the outermost call only), each between two device
synchronises, per prove; host clock.  Left out unless the MSMs counted
equal the engine's own count by route (`msm_counts` without
`small_batches`)."""


def counted(t) -> bool:
    routes = sum(v for k, v in t["msm_routes"].items()
                 if k != "small_batches")
    return routes == len(t["msm_points"]) > 0


def read(rec):
    t = rec.get("timed")
    if not t or not t["proves"] or not counted(t):
        return None
    return t["msm_s"] / t["proves"]
