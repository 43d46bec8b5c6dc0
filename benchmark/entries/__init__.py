"""The code that runs the system under test, one module per entry point. Each has
``setup(run)`` (build the system and its traffic, warm up every shape the
cell uses), ``window(run)`` (the measured window: ``run.e2e``,
``run.attempted``, ``run.failed`` and ``run.counters``), ``release(run)``
(free the system's state once the window has closed) and
``compare(run, control)`` (the numbers that decide ``correct``, against
the plain reference: the system's outputs, or with ``control`` the
reference itself in TF32 in their place)."""
