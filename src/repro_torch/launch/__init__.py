"""Entry points of the port: ``serve`` (the elastic serving loop), ``train``
(the training driver) and ``steps.plan_cell`` (a cell's train, prefill or
decode step)."""
