"""Device milliseconds with an operation running, a unit of work (a step or a
request), over the traced stretch: the device's share of a unit, which the
host's pace does not move."""


def read(r):
    return 1e3 * r.profile["busy_s"] / r.units if r.units else None
