"""prove_s: the untraced window's length over the proves started in it
(each `HyperPlonk.prove` and `serialize_proof`, one in flight); the window
closes when the last prove started ends.  Host clock."""


def read(rec):
    w = rec["window"]
    return w["seconds"] / w["proves"] if w["proves"] else None
