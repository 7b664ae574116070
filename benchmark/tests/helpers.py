"""Small configurations and mixes for the benchmark's CPU tests: the
cells' own files with the widths and the frame cut down."""

from __future__ import annotations

import copy
import json

import torch

from benchmark.harness import spec

#: widths at which the CPU runs a frame in well under a second
DMC_TINY = dict(ch_d=16, ch_y=8, ch_z=8, ch_recon=24)
DMCI_TINY = dict(enc_dec=32, N=16, z_channel=8)
FRAME = {"height": 128, "width": 192}
TINY = {"dmc": DMC_TINY, "dmci": DMCI_TINY}


def few_threads() -> None:
    torch.set_num_threads(min(4, torch.get_num_threads()))


def config_file(name: str) -> dict:
    """A configuration file of ``benchmark/configs`` by its name, listed in
    ``BENCHMARK.json`` or not."""
    with open(spec.BENCH / "configs" / f"{name}.json") as f:
        return json.load(f)


def tiny_config(name: str, frame=FRAME) -> dict:
    """A configuration at tiny widths and a small frame."""
    c = copy.deepcopy(config_file(name))
    c["model"].update(TINY[c["codec"]])
    c["frame"] = dict(frame)
    return c
