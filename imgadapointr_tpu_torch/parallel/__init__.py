"""Multi-GPU execution of the port: the collectives (:mod:`.dist`), the
``(dp, tp, sp)`` mesh and its sharding rules (:mod:`.mesh`) and the GPipe
combinator (:mod:`.pipeline`). Counterpart of ``imgadapointr_tpu/parallel/``."""
