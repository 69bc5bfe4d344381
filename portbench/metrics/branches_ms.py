"""Device milliseconds a unit of work of the port's branch networks: the image
encoder, GDANet and the two fusion stacks (the ``branch.*`` spans; CUDA
events), over the traced stretch."""

from portbench.program_spans import per_unit_ms


def read(r):
    return per_unit_ms(r, ("branch.image_encoder", "branch.gdanet", "branch.img_fusion", "branch.seg_fusion"),
                       "device")
