"""Host milliseconds a step in the port's forward and loss spans
(``runner.forward``, ``runner.loss``), over the traced stretch."""

from portbench.program_spans import per_unit_ms


def read(r):
    return per_unit_ms(r, ("runner.forward", "runner.loss"), "host")
