"""The port's own spans (``imgadapointr_tpu_torch/utils/trace.py``) as
per-layer readings. The spans record while the traced stretch's profiler
records, so they cover that stretch alone; their host times carry the
profiler's slowing of the host, and their device times come from CUDA
events on the port's stream."""


def per_unit_ms(r, names, clock: str):
    """Milliseconds a unit of work (a step or a request) of the outermost
    spans named in ``names`` on ``clock`` (``host`` or ``device``); None
    where the port has no tracer or recorded no such span."""
    try:
        from imgadapointr_tpu_torch.utils import trace
    except ImportError:
        return None
    ms = trace.total_ms(names, clock)
    return ms / r.units if ms is not None and r.units else None
