"""The reference's acceptance suites on the port (``tests/scripts/*_suite.py``),
one module each: ``workload``, ``telemetry``, ``search_scale``, ``serving``
and ``verify``.

Each module has ``run(device="cuda", *, small=False, chip=H100, out=None)``,
which raises :class:`~repro_torch.suites.common.SuiteFailure` on any failed
check and returns a summary dict, and a ``__main__``::

    PYTHONPATH=src python -m repro_torch.suites.<name> --device cpu|cuda \
        [--chip h100|v5e] [--out build/suites/<file>.json]

``chip`` is the ``ChipSpec`` the search and the l3 model price on: the
port's card (``H100``) by default, the reference's (``V5E``) to regenerate
the reference's checked-in artifacts. An artifact goes to ``out``, by
default ``build/suites/`` of the checkout, never over the root's
``BENCH_*.json``. On CUDA tensors the Hopper kernels run (or the suite
raises); on the CPU their plain versions.
"""
