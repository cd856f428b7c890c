"""Entry points that launch the port's jobs (``python -m
repro_torch.launch.train``)."""
