"""rgbd_recon_torch — the PyTorch / CUDA port of rgbd_recon_tpu."""
