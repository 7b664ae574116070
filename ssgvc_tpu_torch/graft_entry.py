"""The flagship model's P-frame forward as one pure function:

    from ssgvc_tpu_torch.graft_entry import entry
    fn, args = entry()          # on the card; entry(device="cpu") for the CPU
    out = fn(*args)             # {'dpb': {'frame', 'feature'}, 'bpp', ...}

``entry`` mirrors the JAX package's ``__graft_entry__.entry``: the DMC
performance variant in bf16, raw io, one 256x256 frame, a zero frame, mask
and DPB, QP 32, the P-frame after an I-frame (``after_i=True``), estimated
rates (``train=False``). Its 31 DepthConvBlocks run as 19 single-block and
5 chained kernel launches on the card.

The JAX module's other hook, ``dryrun_multichip`` (a training step and the
row-sharded P-frame over n devices), needs the data-parallel and spatial
sharding of ``parallel/``, which the port does not have yet; it is not
defined here.
"""

from __future__ import annotations

import torch

from .config import DMCConfig
from .models.dmc import DMC

#: the example's batch, frame size and QP
B, H, W = 1, 256, 256
QP = 32


def entry(device=None):
    """(fn, example_args) of one P-frame forward of the flagship model.
    ``fn(params, frame, mask, qp, dpb)`` runs ``DMC.forward`` with
    ``params`` (a state_dict) through ``torch.func.functional_call``, so it
    is pure in them. The example params are the port's own init
    (``DMC.init_`` from a ``torch.Generator`` seeded 0). ``device``
    defaults to "cuda"; without a CUDA device that raises, as the models
    do."""
    device = torch.device("cuda" if device is None else device)
    cfg = DMCConfig.variant("performance", dtype="bfloat16")
    model = DMC(cfg, device=device)
    model.init_(torch.Generator().manual_seed(0))
    model.eval()

    zeros = lambda *shape: torch.zeros(shape, device=device)
    frame = zeros(B, H, W, 3)
    mask = zeros(B, H, W, 1)
    p = cfg.patch_size
    dpb = {"frame": zeros(B, H, W, 3),
           "feature": zeros(B, H // p, W // p, cfg.ch_d)}
    params = dict(model.state_dict())

    def fn(params, frame, mask, qp, dpb):
        return torch.func.functional_call(
            model, params, (frame, qp, dpb),
            dict(after_i=True, mask=mask, train=False))

    return fn, (params, frame, mask, QP, dpb)
