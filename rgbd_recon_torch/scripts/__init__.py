"""Command-line scripts of the port (``python -m rgbd_recon_torch.scripts.<name>``)."""
