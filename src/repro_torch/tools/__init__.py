"""Measurement scripts of the port, run on a GPU (``python3 -m
repro_torch.tools.<name>`` with ``src`` on ``PYTHONPATH``)."""
