"""Command-line tools of the port, run as ``python -m sfm_tpu_torch.tools.<name>``."""
