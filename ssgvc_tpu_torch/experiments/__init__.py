"""The RD experiment harness: the JAX package's ``experiments/rd_*.py``,
``mask_train_phase.py``, ``mask_prop_value.py``, ``e2e_waymo_format.py``,
``diag_pframe.py`` and ``probes/probe_{latent_liveness,dist_only}.py`` in
PyTorch, each script's functions, flags, printed lines and JSON keys kept.

    python3 -m ssgvc_tpu_torch.experiments.rd_tpu --profile half --lnorm \\
        --recon-skip [--device=cpu] ...
    python3 -m ssgvc_tpu_torch.experiments.rd_eval --profile half ...
    python3 -m ssgvc_tpu_torch.experiments.rd_continue [steps] ...
    python3 -m ssgvc_tpu_torch.experiments.rd_keep_best <cycle>
    python3 -m ssgvc_tpu_torch.experiments.rd_full [steps] ...
    python3 -m ssgvc_tpu_torch.experiments.rd_demo [steps]
    python3 -m ssgvc_tpu_torch.experiments.mask_train_phase [steps] ...
    python3 -m ssgvc_tpu_torch.experiments.mask_prop_value [--qps ...] ...
    python3 -m ssgvc_tpu_torch.experiments.e2e_waymo_format
    python3 -m ssgvc_tpu_torch.experiments.rd_trajectory [logfile]
    python3 -m ssgvc_tpu_torch.experiments.rd_report
    python3 -m ssgvc_tpu_torch.experiments.diag_pframe [--res 64] \\
        [--variant performance]
    python3 -m ssgvc_tpu_torch.experiments.probes.probe_latent_liveness \\
        [steps]
    python3 -m ssgvc_tpu_torch.experiments.probes.probe_dist_only \\
        [variant] [steps]

Every script that runs a model runs on the card unless ``--device=cpu``
is given; rd_keep_best, rd_trajectory and rd_report read and write files
only. ``rd_report`` writes ``artifacts/torch/RESULTS.md``, never the
committed ``RESULTS.md``. Every
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


def restore_fitting(path: str, **models) -> dict:
    """The checkpoint file at ``path`` (``utils/checkpoint``), each entry
    named by a keyword checked against its model (``params_i=dmci``,
    ``params_p=dmc``): an entry the file lacks, a key missing or unexpected,
    or a shape that differs raises ValueError naming ``path``, so a caller
    that loads after this check never loads a checkpoint in part. Loads
    nothing itself."""
    from ..utils.checkpoint import restore_checkpoint

    ck = restore_checkpoint(path)
    for name, model in models.items():
        if name not in ck:
            raise ValueError(f"checkpoint {path} has no {name}")
        want = model.state_dict()
        got = ck[name]
        missing = sorted(want.keys() - got.keys())
        extra = sorted(got.keys() - want.keys())
        shapes = sorted(k for k in want.keys() & got.keys()
                        if tuple(want[k].shape) != tuple(got[k].shape))
        if missing or extra or shapes:
            raise ValueError(
                f"checkpoint {path}: {name} does not fit the model "
                f"({len(missing)} keys missing, {len(extra)} unexpected, "
                f"{len(shapes)} of another shape; first: "
                f"{(missing + extra + shapes)[:3]})")
    return ck
