"""The collectives the sharded paths run over a mesh
(``parallel.collectives``)."""
from repro_torch.parallel.collectives import (all_gather_stack,  # noqa: F401
                                              all_reduce_sum, axis_group)
