"""Runnable demos of the port (``python -m tpu_ddp_torch.examples.<name>``)."""
