"""Command-line entry points of the port (`python -m
accelerate_tpu_torch.commands.<name>`)."""
