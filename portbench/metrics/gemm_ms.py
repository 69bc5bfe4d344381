"""Device milliseconds of the GEMM kernels (profiler names with 'gemm') a unit
of work (a step or a request), over the traced stretch."""


def read(r):
    return 1e3 * r.device_seconds(lambda n: "gemm" in n.lower()) / r.units if r.units else None
