"""Launchers of the port (``python -m repro_torch.launch.serve``)."""
