"""lookup_s: the program's cross-table lookup spans in the untraced
window, per prove: `prove/lookup_multiplicities` (the count and the
uploads of the lookup's columns and multiplicities),
`prove/lookup_commit` (the multiplicities' commitment),
`prove/lookup_piop` (the set-inclusion PIOP) and `prove/lookup_openings`.
Left out where none of them ran."""

SPANS = ("prove/lookup_multiplicities", "prove/lookup_commit",
         "prove/lookup_piop", "prove/lookup_openings")


def read(rec):
    w = rec["window"]
    if not w["proves"] or not any(s in w["spans"] for s in SPANS):
        return None
    return sum(w["spans"].get(s, 0.0) for s in SPANS) / w["proves"]
