"""Command-line tools of the port (run with `python -m pls_tpu_torch.tools.<name>`)."""
