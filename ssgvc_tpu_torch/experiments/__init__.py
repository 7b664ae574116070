"""The RD experiment harness: the JAX package's ``experiments/rd_*.py`` in
PyTorch, each script's functions, flags and JSON keys kept.

    python3 -m ssgvc_tpu_torch.experiments.rd_tpu --profile half --lnorm \\
        --recon-skip [--device=cpu] ...
    python3 -m ssgvc_tpu_torch.experiments.rd_eval --profile half ...
    python3 -m ssgvc_tpu_torch.experiments.rd_continue [steps] ...
    python3 -m ssgvc_tpu_torch.experiments.rd_keep_best <cycle>
    python3 -m ssgvc_tpu_torch.experiments.rd_full [steps] ...
    python3 -m ssgvc_tpu_torch.experiments.rd_demo [steps]

Every script runs on the card unless ``--device=cpu`` is given. Every
artifact lands under :data:`ARTIFACTS`, relative to the working directory,
so no run of the port overwrites the JAX package's records in
``artifacts/``. A checkpoint is one file of the port's format
(``utils/checkpoint.py``), where the JAX harness keeps orbax directories:
its ``.prev`` and ``.best`` snapshots are copies of that file
(:func:`copy_checkpoint`).
"""

from __future__ import annotations

import os
import shutil
from typing import List, Tuple

#: every path the harness writes, relative to the working directory
ARTIFACTS = "artifacts/torch"


def split_device(argv: List[str]) -> Tuple[str, List[str]]:
    """(``--device=X``'s X, by default "cuda"; the other arguments)."""
    device, rest = "cuda", []
    for a in argv:
        if a.startswith("--device="):
            device = a.partition("=")[2]
        else:
            rest.append(a)
    return device, rest


def copy_checkpoint(src: str, dst: str) -> None:
    """``dst`` becomes a copy of the checkpoint file ``src``: written beside
    it, then renamed over it, so a reader never sees a partial file."""
    tmp = dst + ".tmp"
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def write_json(path: str, obj) -> None:
    """``obj`` as indented JSON at ``path``, its directory made first."""
    import json

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
