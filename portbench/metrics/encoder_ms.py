"""Device milliseconds a unit of work of the port's encoder (``model.encoder``:
the input projection, the positional embedding and the encoder blocks; CUDA
events), over the traced stretch."""

from portbench.program_spans import per_unit_ms


def read(r):
    return per_unit_ms(r, ("model.encoder",), "device")
