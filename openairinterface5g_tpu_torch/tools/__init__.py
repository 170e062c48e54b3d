"""Command-line tools of the port: ``python -m openairinterface5g_tpu_torch.tools.<name>``."""
