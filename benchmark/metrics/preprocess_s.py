"""preprocess_s: `HyperPlonk.preprocess` (the verifying key's
commitments), ended by a device synchronise.  Host clock, set-up."""


def read(rec):
    return rec["setup"]["preprocess_s"]
