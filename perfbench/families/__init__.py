"""Model families, one module each, found by the ``family`` of a
configuration file (``perfbench/configs/<config>.json``).

A family module gives the harness what it must know of one kind of model:

- ``build(cfg, seed, dtype, device)``: the served model on ``device``,
  its weights drawn from ``seed`` in ``dtype``, and the set-up's clock
  marks inside the weights' part, ``[(name, time.perf_counter()), ...]``
  in order, each taken after a synchronize;
- ``judge(cfg, seed, dtype, device, control=False)``: the plain reference
  that reads the program's outputs (``control``: the reference in the
  nearest precision below the configuration's, put in the program's
  place);
- ``host_phases()``: the program's dict of host seconds by phase, which
  the harness clears before the window and reads after it (``{}`` where
  the program keeps none);
- ``tiny(cfg)``: the configuration shrunk in place for the CPU tests;
- ``check_config(cfg)``: raises ``ValueError`` where the file is not a
  configuration of the family;
- optionally ``RULES`` and ``KERNELS``, shaped like ``roofline.py``'s:
  the bytes and operations of each ``ops/`` wrapper that only this
  family's model calls, and the kernels each launches. A cell's traced run
  wraps and matches ``roofline.RULES`` joined with them (``Cell.rules``,
  ``Cell.kernels``); a wrapper in both raises. A share of one wrapper's
  roofline is then a metric file that returns
  ``readers.wrapper_roofline(ctx, '<module>.<wrapper>')``.

The traffic kind (``perfbench/generators/<kind>.py``) is given the
configuration's ``dims`` and serves the model that ``build`` returns.
"""
