"""witness_prep_s: the program's `prove/check_constraints` (the
constraints checked in Python) and `prove/witness_upload` (the witness
flattened and the columns loaded from Python ints) spans in the untraced
window, per prove."""

SPANS = ("prove/check_constraints", "prove/witness_upload")


def read(rec):
    w = rec["window"]
    if not w["proves"] or not any(s in w["spans"] for s in SPANS):
        return None
    return sum(w["spans"].get(s, 0.0) for s in SPANS) / w["proves"]
