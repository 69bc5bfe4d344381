"""Device milliseconds a step of SnowFlakeNet's feature extractor
(``model.sf_extractor``: three set abstractions and two point
transformers), forward only, on CUDA events, over the traced stretch."""

from portbench.program_spans import per_unit_ms


def read(r):
    return per_unit_ms(r, ("model.sf_extractor",), "device")
