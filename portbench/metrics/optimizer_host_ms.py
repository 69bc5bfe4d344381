"""Host milliseconds a step in the port's gradient clip and optimizer update
(``runner.clip``, ``runner.optimizer``), over the traced stretch."""

from portbench.program_spans import per_unit_ms


def read(r):
    return per_unit_ms(r, ("runner.clip", "runner.optimizer"), "host")
