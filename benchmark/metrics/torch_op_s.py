"""torch_op_s: device time of everything else in the traced window's
profiler trace (PyTorch's own kernels, copies and fills), per prove."""


def read(rec):
    t = rec.get("traced")
    if not t or not t["proves"] or not t["device_s_by_name"]:
        return None
    names = rec["kernel_names"]
    return sum(s for k, s in t["device_s_by_name"].items()
               if k not in names) / t["proves"]
