"""Weights drawn from the seed, on the device, in one call.

A configuration's ``weights`` rule names the scale of each parameter by
the model's ``state_dict`` names:

  * a conv weight (4-D) is N(0, 1 / fan_in) (lecun scale), times every
    factor in ``scale`` whose pattern (``fnmatch``) matches its name;
  * a per-QP table or gain matching ``tables`` is ``mean`` + N(0, std);
  * anything else (biases, the factorized CDF's parameters) is
    N(0, ``other_std``);
  * ``fill`` sets a parameter to a constant.

All of them come from one normal draw of ``torch.Generator`` on the
device, in fp32, the type the parameters are kept in, and are split in
the order of the ``state_dict``.
"""

from __future__ import annotations

import fnmatch
import math
from typing import Dict

import torch


def draw(template: Dict[str, torch.Size], rule: dict, seed: int,
         device) -> Dict[str, torch.Tensor]:
    """A state dict of ``template``'s names and shapes, drawn by ``rule``
    from ``seed`` on ``device``."""
    names = list(template)
    sizes = [math.prod(template[n]) for n in names]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device,
                       dtype=torch.float32)
    tables = rule["tables"]
    out, off = {}, 0
    for name, size in zip(names, sizes):
        shape = template[name]
        t = flat[off:off + size].view(shape)
        off += size
        if any(fnmatch.fnmatchcase(name, p) for p in tables["patterns"]):
            t = t * tables["std"] + tables["mean"]
        elif len(shape) == 4:
            std = math.prod(shape[1:]) ** -0.5
            for pattern, factor in rule["scale"].items():
                if fnmatch.fnmatchcase(name, pattern):
                    std *= factor
            t = t * std
        else:
            t = t * rule["other_std"]
        out[name] = t
    for name, value in rule.get("fill", {}).items():
        out[name] = torch.full_like(out[name], value)
    return out
