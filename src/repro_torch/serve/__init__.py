"""Serving front end over the port's ANN engines (``ann_service``).

Counterpart of ``repro.serve``'s ``AnnService``; the LM serving loop
(``repro/serve/serving.py``) belongs to the LM scaffold, ROADMAP queue A
item 13.
"""
from repro_torch.serve.ann_service import AnnService, AnnServiceConfig  # noqa: F401
