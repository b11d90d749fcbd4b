"""Runnable examples of the port (``python -m torchmpi_tpu_torch.examples.<name>``)."""
