"""unspanned_idle_s: seconds the device sat idle in the traced window
while no span of the program's own was open below the prove, per prove:
`idle_by_span` under the labels `prove` (the harness's span around
`HyperPlonk.prove` + `serialize_proof`, and the program's root span of
the same name) and `between proves`.  Left out where the trace saw no
device event."""

LABELS = ("prove", "between proves")


def read(rec):
    t = rec.get("traced")
    if not t or not t["proves"] or not t["busy_s"]:
        return None
    return sum(t["idle_by_span"].get(k, 0.0) for k in LABELS) / t["proves"]
