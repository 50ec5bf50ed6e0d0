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
  configuration of the family.

The traffic kind (``perfbench/generators/<kind>.py``) is given the
configuration's ``dims`` and serves the model that ``build`` returns.
"""
