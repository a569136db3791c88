"""Runnable examples of the port (``python -m hamilton_tpu_torch.examples.<name>``)."""
