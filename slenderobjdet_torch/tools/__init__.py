"""Measurement tools of the port, each runnable as
``python -m slenderobjdet_torch.tools.<name>`` on a CUDA card."""
