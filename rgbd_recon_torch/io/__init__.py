"""Scene, stream and control-surface I/O (mirrors ``rgbd_recon_tpu/io``)."""
