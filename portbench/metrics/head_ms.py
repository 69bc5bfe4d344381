"""Device milliseconds a unit of work of the port's rebuild head (``model.head``:
``increase_dim``, ``reduce_map``, the folding or FC head and the rebuild; CUDA
events), over the traced stretch."""

from portbench.program_spans import per_unit_ms


def read(r):
    return per_unit_ms(r, ("model.head",), "device")
