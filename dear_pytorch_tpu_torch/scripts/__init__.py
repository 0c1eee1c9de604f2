"""Command-line probes of the port (``python -m
dear_pytorch_tpu_torch.scripts.<name>``)."""
