"""lookup_host_idle_s: seconds the device sat idle in the traced window
while a span of the lookup path was the innermost open (`prove/lookup_*`
and the set-inclusion PIOP's `set_inclusion/*`: the host's count,
uploads and steps between the lookup's launches), per prove.  Left out
where the trace saw no device event, or where no such span ran."""

PREFIXES = ("prove/lookup_", "set_inclusion/")


def read(rec):
    t = rec.get("traced")
    if not t or not t["proves"] or not t["busy_s"]:
        return None
    idle = [s for k, s in t["idle_by_span"].items()
            if k.startswith(PREFIXES)]
    return sum(idle) / t["proves"] if idle else None
