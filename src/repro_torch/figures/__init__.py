"""The paper's tables and figures on the port (``benchmarks/``), one module
each: ``fig3_flash_attention``, ``fig4_moe_skew``, ``fig5_kv_transfer``,
``fig6_gemm_allgather``, ``table5_moe_phases``, ``fig9_13_ablations`` and
``roofline_cells``; ``run`` drives them all.

Each figure module has ``run(device="cuda", *, chip=H100, mesh=None,
measure=True, small=False, iters=5, out=None, **figure_args)`` returning
the reference's ``(name, us_per_call, derived)`` rows: the same names, the
same modeled us (the l3 model on ``chip``, at the paper's shape) and the
same ``derived`` strings. ``measure=False`` gives exactly the reference's
rows on ``chip`` (``V5E`` for the reference's own). With ``measure`` each
point the workload's ``check`` accepts also runs on ``device`` at the
paper's shape (``small``: every measured dimension over 64) through its
Hopper kernel (or plain torch for a host point), is held to the
workload's ``reference()`` and timed (``common.point_us``: the median of
``iters`` calls, the L2 flushed before each, and their range): a
``<name>_card`` row after the modeled one. ``out`` writes the rows as a
``bench-rows/v1`` table::

    PYTHONPATH=src python -m repro_torch.figures.run --device cuda|cpu \
        [--out build/figures] [--small]
"""
