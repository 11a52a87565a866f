"""device_idle_pct: 100 x (1 - the union of the device's event intervals
over the traced window's length), from the profiler trace."""


def read(rec):
    t = rec.get("traced")
    if not t or not t["seconds"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["seconds"])
