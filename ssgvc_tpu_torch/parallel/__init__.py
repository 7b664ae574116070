"""Data-parallel training over ``torch.distributed`` (``mesh``) and the
row-sharded P-frame (``spatial``): the JAX package's ``parallel/``."""
