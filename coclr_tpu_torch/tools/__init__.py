"""Command-line tools of the port (`python -m coclr_tpu_torch.tools.<name>`)."""
