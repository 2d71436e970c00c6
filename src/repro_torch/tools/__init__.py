"""The port's card tooling: the kernel table and the measurement scripts
around it, run on a GPU (``PYTHONPATH=src python3 -m
repro_torch.tools.<name>``)."""
