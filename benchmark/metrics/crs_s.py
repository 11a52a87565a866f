"""crs_s: `KZG.device_setup`, the CRS of columns x rows + 1 points made on
the card from tau, ended by a device synchronise.  Host clock, set-up."""


def read(rec):
    return rec["setup"]["crs_s"]
