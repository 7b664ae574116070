"""ssgvc_tpu_torch: the PyTorch/CUDA port of the segmentation-guided neural
video codec, for one NVIDIA Hopper GPU (sm_90a).

Layout mirrors the JAX package: ``config``, ``ops`` (pixel patching and the
hand-written DepthConvBlock kernels with their plain PyTorch versions),
``layers``, ``models`` and ``utils``. Tensors are NHWC at every public
function. Entry points run on the card unless the caller passes
``device="cpu"``; a CPU tensor takes each kernel's plain version.
"""
