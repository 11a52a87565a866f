"""msm_host_idle_s: seconds the device sat idle in the traced window
while an MSM span was the innermost open (`msm/<route>` and the routes'
own `msm/<route>/<step>` spans: the host between the routes' launches),
per prove.  Left out where the trace saw no device event, or where the
program has no MSM span."""


def read(rec):
    t = rec.get("traced")
    if not t or not t["proves"] or not t["busy_s"]:
        return None
    idle = [s for k, s in t["idle_by_span"].items() if k.startswith("msm/")]
    return sum(idle) / t["proves"] if idle else None
