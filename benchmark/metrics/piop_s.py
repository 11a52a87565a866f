"""piop_s: the program's `prove/zerocheck`, `prove/permutation_check` and
`prove/lookup_piop` spans in the untraced window, per prove.  The
permutation check commits its own tables, so this overlaps msm_s."""

SPANS = ("prove/zerocheck", "prove/permutation_check", "prove/lookup_piop")


def read(rec):
    w = rec["window"]
    if not w["proves"] or not any(s in w["spans"] for s in SPANS):
        return None
    return sum(w["spans"].get(s, 0.0) for s in SPANS) / w["proves"]
