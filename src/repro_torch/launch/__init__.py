"""Entry points of the port: ``serve`` (the elastic serving loop), ``train``
(the training loop), ``steps.plan_cell`` (a cell's train, prefill or
decode step, on one device or a mesh), ``mesh`` (device meshes) and
``specs`` (shape stand-ins of a cell's inputs)."""
