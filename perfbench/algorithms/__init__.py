"""One driver a kind of configuration, named by the configuration's
``algorithm`` key.

A driver is a class ``Driver(cell, seed, device, traffic, overrides)``:

* ``kernels``: the dispatch ops (``repro_torch.kernels.launches``) its
  tasks launch;
* ``prepare()``: the inputs from the seed, the program's spec;
  ``warm(run_job)``: one small job on the pool, which builds and loads
  the kernels and warms the allocator;
* ``job(k) -> (spec, run_irregular keywords)``; ``job_done(k, output)``;
* ``before(job, tag, item) -> token`` and ``after(rec, token, item,
  result)`` around each task body (``tag`` is the item's in
  ``harness.Lineage``, None for an item nothing gave out),
  ``seeded(job, items)`` on a job's seed items, ``folded(job, tag,
  state, result, new_state)`` after each fold: what the check and the
  metrics need of each task;
* ``check(ctx) -> [Check]`` against the plain references, once the window
  has closed and the pool, with every bag it held, is gone.
"""
