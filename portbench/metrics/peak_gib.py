"""Peak device memory the window allocated, in GiB."""


def read(r):
    return r.peak_bytes / 2**30
