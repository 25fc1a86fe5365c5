"""Multi-rank reconstruction on ``torch.distributed`` (mirrors
``rgbd_recon_tpu/parallel/``): the dense oracle step over z-slabs
(``sharding``), the brick-sparse fast step over z-slabs with the windowed
sweep (``fast_sharded``) and batched sequence replay (``replay``)."""
