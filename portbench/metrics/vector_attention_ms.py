"""Device milliseconds a step of SnowFlakeNet's vector attention
(``model.sf_attention``: the kNN, the key and position gathers, the
position and attention MLPs with their BatchNorms, the softmax over the
neighbours and the weighted sum; five calls a forward, inside the spans of
``extractor_ms`` and ``spd_ms``), forward only, on CUDA events, over the
traced stretch."""

from portbench.program_spans import per_unit_ms


def read(r):
    return per_unit_ms(r, ("model.sf_attention",), "device")
