"""Host milliseconds a step in the port's backward span (``runner.backward``:
the autograd engine's walk, issuing the backward's kernels), over the traced
stretch."""

from portbench.program_spans import per_unit_ms


def read(r):
    return per_unit_ms(r, ("runner.backward",), "host")
