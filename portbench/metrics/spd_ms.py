"""Device milliseconds a step of SnowFlakeNet's three snowflake point
deconvolutions (``model.sf_spd``: each SPD's MLPs, skip-transformer,
point-wise splitting and displacement), forward only, on CUDA events, over
the traced stretch."""

from portbench.program_spans import per_unit_ms


def read(r):
    return per_unit_ms(r, ("model.sf_spd",), "device")
