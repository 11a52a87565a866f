"""csrc_kernel_s: device time of the program's hand-written kernels (the
names in `kernels/*.txt`) in the traced window's profiler trace, per
prove."""


def read(rec):
    t = rec.get("traced")
    if not t or not t["proves"] or not t["device_s_by_name"]:
        return None
    names = rec["kernel_names"]
    return sum(s for k, s in t["device_s_by_name"].items()
               if k in names) / t["proves"]
