"""Serving front ends: ``AnnService`` over the port's ANN engines
(``ann_service``) and the LM's prefill/decode loop (``serving``),
counterparts of ``repro.serve``."""
from repro_torch.serve.ann_service import AnnService, AnnServiceConfig  # noqa: F401
from repro_torch.serve.serving import generate, make_serve_step  # noqa: F401
