"""Traffic kinds, one module each, found by the ``kind`` of a traffic file.

A kind module gives the harness a ``Workload`` (``core/workload.py``) and
its CPU tests three things more:

- ``tiny(params)``: the traffic file's parameters shrunk in place for the
  CPU;
- ``FAULTS``: functions ``fault(monkeypatch)``, each planting an error in
  the program's answers where they are produced; a run with any of them
  must come out not correct;
- ``CARD_ONLY``: the names of the per-layer metrics that a CPU run cannot
  report (absent there, never 0).
"""
