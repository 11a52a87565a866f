"""pcs_open_s: the program's `prove/witness_openings` and
`prove/id_perm_trace_openings` spans in the untraced window, per prove."""

SPANS = ("prove/witness_openings", "prove/id_perm_trace_openings")


def read(rec):
    w = rec["window"]
    if not w["proves"] or not any(s in w["spans"] for s in SPANS):
        return None
    return sum(w["spans"].get(s, 0.0) for s in SPANS) / w["proves"]
