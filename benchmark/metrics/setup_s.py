"""setup_s: process start to the first prove of the window: imports,
building or loading the kernels, the witness, the CRS, preprocess and the
cell's warm-up proves.  Host clock."""


def read(rec):
    return rec["setup"]["setup_s"]
