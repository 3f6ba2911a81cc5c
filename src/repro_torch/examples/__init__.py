"""The reference's examples on the port
(``python -m repro_torch.examples.<name>``): ``quickstart``,
``serve_decode``, ``codesign_search`` and ``train_moe_100m``. Each takes
the reference script's flags and defaults, runs on ``cuda`` unless
``--device cpu`` is given, and never falls back to the CPU on its own."""
