"""Host milliseconds a step the traced stretch's loop waits in the loader for
its next batch (the benchmark's span around that call)."""


def read(r):
    return 1e3 * r.spans.recorded_seconds("loader_wait") / r.units if r.units else None
