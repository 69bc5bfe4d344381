"""Device operations a unit of work (a step or a request), counted in the trace."""


def read(r):
    return r.profile["launches"] / r.units if r.units else None
