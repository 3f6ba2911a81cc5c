"""The reference's CI tools on the port
(``python -m repro_torch.tools.schedule_lint``)."""
