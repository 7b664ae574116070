"""The comparison's control: the program's own int8 path switched on.

The configurations state bf16 compute; the nearest precision below is
int8, and the program has such a path of its own: ``SSGVC_INT8=1`` runs
every ``groups == 1`` conv as a W8A8 int8 conv with a dynamic per-tensor
activation scale (``ssgvc_tpu_torch/ops/qconv.py``), read at each
forward. A run with ``control="int8"`` has to come out not correct.
"""

from __future__ import annotations

import contextlib
import os

CONTROLS = (None, "int8")


@contextlib.contextmanager
def env(control):
    """``SSGVC_INT8=1`` for the block under the int8 control, restored
    after; nothing otherwise."""
    if control not in CONTROLS:
        raise ValueError(f"control {control!r}: want one of {CONTROLS}")
    if control is None:
        yield
        return
    old = os.environ.get("SSGVC_INT8")
    os.environ["SSGVC_INT8"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["SSGVC_INT8"]
        else:
            os.environ["SSGVC_INT8"] = old


def worst(per: dict, key: str, t: int, value: float) -> None:
    """``per[key][t]`` raised to ``value``; a NaN, once there, stays."""
    cur = per[key][t]
    if cur == cur and not value <= cur:
        per[key][t] = value
