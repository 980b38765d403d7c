"""Runnable examples of the port (``python -m sageattention_tpu_torch.examples.<name>``)."""
