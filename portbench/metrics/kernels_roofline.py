"""The port's kernels' least time on the chip over their device time, summed
over the traced stretch's calls, with the peaks it divides by; None where the
stretch made none."""


def read(r):
    return r.kernels_roofline_pct()
