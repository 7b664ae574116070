"""The I-frame codec's adapter: ``ssgvc_tpu_torch.models.dmci.DMCI`` as the
system under test, ``reference/dmci.py`` beside it.

A group is ``traffic["group"]`` steps of ``traffic["streams"]``
independent frames each, drawn uniform on the card before the window
(``source`` "device"); every step is one forward of the batch.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from benchmark.harness import control as ctl
from benchmark.harness import spec, weights
from benchmark.harness.count import Count, count
from benchmark.reference import dmci as ref

#: what the comparison reads of each compared frame: the decoded frame's
#: mean squared error, the rate's relative error
READINGS = ("frame_mse", "bpp_rel")


class Codec:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control: Optional[str] = None):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.control = control
        self.streams = traffic["streams"]
        self.group = traffic["group"]
        self.h, self.w = config["frame"]["height"], config["frame"]["width"]
        self.r = config["model"]["patch_size"]
        if traffic["source"] != "device":
            raise ValueError(f"source {traffic['source']!r}: the I-frame "
                             "adapter takes 'device'")

    # -- set-up ------------------------------------------------------------

    def kernels(self) -> List[str]:
        return list(self.config["kernels"]) + (
            ["qconv"] if self.control == "int8" else [])

    def build(self) -> None:
        """The kernels built (the first run only), the model, its weights
        drawn from the seed on the device; the seconds of each part in
        ``build_parts``."""
        t = [time.perf_counter()]
        from ssgvc_tpu_torch.config import DMCIConfig
        from ssgvc_tpu_torch.models.dmci import DMCI

        t.append(time.perf_counter())
        if self.device.type == "cuda":
            from ssgvc_tpu_torch.ops import _build
            _build.build(self.kernels())
        t.append(time.perf_counter())
        cfg = DMCIConfig(**self.config["model"])
        model = DMCI(cfg, device=self.device).eval()
        t.append(time.perf_counter())
        template = {k: v.shape for k, v in model.state_dict().items()}
        self.sd = weights.draw(template, self.config["weights"],
                               spec.sub_seed(self.seed, "weights"),
                               self.device)
        model.load_state_dict(self.sd, strict=True)
        t.append(time.perf_counter())
        self.build_parts = dict(zip(("imports", "kernels", "model",
                                     "weights"),
                                    (b - a for a, b in zip(t, t[1:]))))
        self.model, self.cfg = model, cfg
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" \
            else torch.float32

    def make_inputs(self) -> None:
        """The frames of a group, uniform in [0, 1], from the seed."""
        g = torch.Generator(device=self.device).manual_seed(
            spec.sub_seed(self.seed, "inputs"))
        self.frames = torch.rand(
            (self.group, self.streams, self.h, self.w, 3), generator=g,
            device=self.device).to(self.dtype)

    # -- the timed path ----------------------------------------------------

    def start(self):
        return None

    def step(self, t: int, state, qp: int):
        """Queue step ``t`` of the group: (its outputs, no state)."""
        with torch.no_grad(), ctl.env(self.control):
            return self.model(self.frames[t], qp), None

    @staticmethod
    def bpp(out) -> torch.Tensor:
        return out["bpp"]

    @staticmethod
    def keep(out) -> Dict[str, torch.Tensor]:
        return {"frame": out["dpb"]["frame"], "bpp": out["bpp"]}

    def release(self) -> None:
        del self.model

    # -- the comparison ----------------------------------------------------

    def reference(self, kept: List[Dict[str, torch.Tensor]], qp: int
                  ) -> Dict[str, List[float]]:
        """Each reading of each step of the kept group, the worst frame's
        of the step."""
        per = {k: [0.0] * len(kept) for k in READINGS}
        for t, k in enumerate(kept):
            for b in range(self.streams):
                r = ref.forward(self.sd, self.frames[t, b:b + 1].float(), qp,
                                self.r)
                got = k["frame"][b:b + 1].float()
                read = {"frame_mse": float(torch.mean((got - r["frame"])
                                                      ** 2)),
                        "bpp_rel": float(abs(k["bpp"][b].float()
                                             - r["bpp"][0]) / r["bpp"][0])}
                for key, v in read.items():
                    ctl.worst(per, key, t, v)
                del r
        return per

    # -- the yardstick -----------------------------------------------------

    def count(self) -> Count:
        """Products of one frame, on the meta device."""
        from ssgvc_tpu_torch.config import DMCIConfig
        from ssgvc_tpu_torch.models.dmci import DMCI

        shapes = {k: v.shape for k, v in DMCI(
            DMCIConfig(**self.config["model"]),
            device="meta").state_dict().items()}
        sd = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
        x = torch.empty((1, self.h, self.w, 3), device="meta")
        return count(lambda: ref.forward(sd, x, 0, self.r))
