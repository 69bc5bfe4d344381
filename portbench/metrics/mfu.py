"""Model FLOPs of the untraced stretch's clouds over its seconds times the
float32 peak (67 TFLOP/s), with the peak; None without an untraced stretch."""


def read(r):
    return r.mfu_pct()
