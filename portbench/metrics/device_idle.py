"""Share of the time in which no operation ran on the device: one minus the
device's busy time a unit (trace) over the untraced stretch's time a unit."""


def read(r):
    return r.idle_pct()
