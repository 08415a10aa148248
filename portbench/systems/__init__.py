"""Kinds of system under test, one module each, found by the name a
configuration gives under ``"system"`` (``common.system_kind``). A new kind
is new files only: its module here, its plain reference under
``reference/``, configurations, mixes, limits and metric readers, and
entries in ``BENCHMARK.json``.

A kind's module gives:

* ``System(conf, mix, seed, device, fault=None, rank=0)``: the program
  built from a configuration and a mix, stepped by ``step(k)`` (the
  metrics as 0-d tensors); ``plan()`` (shapes and inputs, no program),
  ``build()``, ``free()``; ``images_per_step``, ``rates(images,
  seconds)`` (the cell's end-to-end rates by name); for the comparison
  (``check.py``) ``grad_norms()``, ``trained_params()``,
  ``initial_params()``, ``shards(k)``, ``reference()``, ``control()``
  (the reference at the precision below the configuration's, in the
  program's place), ``reference_grad_norms(state)``,
  ``reference_params(state)``, ``leaf_groups()``, ``compared_groups()``,
  ``loss_names()``; for the readers ``flops_per_step()`` and
  ``attention_work(k)``;
* ``SPANS``: the program's phase spans, which ``spans.reduce`` splits the
  card's time by;
* ``faults(world)``: the faults ``fault`` can plant in a cell of
  ``world`` ranks, each of which the check has to find;
* the tiny form the CPU tests run (``tests/tiny.py``): ``tiny_config(conf,
  **overrides)``, ``tiny_mix(mix)`` and ``TINY_LIMITS``.
"""
