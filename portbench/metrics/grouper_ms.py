"""Device milliseconds a unit of work of the port's grouper (``model.grouper``:
DGCNN's FPS, kNN and edge convolutions; CUDA events), over the traced stretch."""

from portbench.program_spans import per_unit_ms


def read(r):
    return per_unit_ms(r, ("model.grouper",), "device")
