"""sumcheck_s: the engine's `sumcheck_begin` and `sumcheck_round_fused`
calls in the timed pass of a traced run, each between two device
synchronises, per prove; host clock."""


def read(rec):
    t = rec.get("timed")
    if not t or not t["proves"] or not t["sumcheck_calls"]:
        return None
    return t["sumcheck_s"] / t["proves"]
