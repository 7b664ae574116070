"""The P-frame codec's adapter: ``ssgvc_tpu_torch.models.dmc.DMC`` as the
system under test, ``reference/dmc.py`` beside it.

A group is a GOP of ``traffic["group"]`` P-frames (``after_i=False``) of
``traffic["streams"]`` independent streams, from a DPB drawn from the
seed, the DPB carried from frame to frame on the card (the port's
``bench.gop``). Frames come from one of two sources:

  * ``device``: drawn on the card before the window, as the port's
    ``experiments/bench_sweep.make_gop_inputs`` draws them (uniform
    frames, masks where a uniform draw exceeds 0.8, a uniform DPB frame,
    an N(0, 0.1) DPB feature);
  * ``pinned_u8``: 8-bit frames and masks in pinned host memory, copied to
    the card, converted and ingested inside each step.

Each step ingests its frame and mask into the packed domain (pixel
unshuffle by 8) and queues the forward.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from benchmark.harness import control as ctl
from benchmark.harness import spec, weights
from benchmark.harness.count import Count, count
from benchmark.reference import dmc as ref
from benchmark.reference.layers import pixel_unshuffle as ref_unshuffle

#: what the comparison reads of each frame: the mean squared error of the
#: decoded frame against the reference's frame from the same DPB
#: (``frame_mse``), and against the reference's reconstruction of the
#: program's own output feature (``recon_mse``: the one stage that no
#: rounding decision of the quantizer precedes); the rate's relative error
#: against the reference's from the same DPB (``bpp_rel``: the bit
#: estimate, which no decoded frame depends on); the DPB feature's
#: relative error is printed beside them
READINGS = ("frame_mse", "recon_mse", "feature_rel", "bpp_rel")


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

    # -- set-up ------------------------------------------------------------

    def kernels(self) -> List[str]:
        return list(self.config["kernels"]) + (
            ["qconv"] if self.control == "int8" else [])

    def build(self) -> None:
        """The kernels built (the first run only), the model, its weights
        drawn from the seed on the device; the seconds of each part in
        ``build_parts``."""
        t = [time.perf_counter()]
        from ssgvc_tpu_torch.config import DMCConfig
        from ssgvc_tpu_torch.models.dmc import DMC

        t.append(time.perf_counter())
        if self.device.type == "cuda":
            from ssgvc_tpu_torch.ops import _build
            _build.build(self.kernels())
        t.append(time.perf_counter())
        m = dict(self.config["model"])
        cfg = DMCConfig.variant(m.pop("variant"), **m)
        model = DMC(cfg, device=self.device).eval()
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
        """The frames, masks and DPB of a GOP, from the seed."""
        n, b, h, w = self.group, self.streams, self.h, self.w
        g = torch.Generator(device=self.device).manual_seed(
            spec.sub_seed(self.seed, "inputs"))
        kw = dict(generator=g, device=self.device)
        self.source = self.traffic["source"]
        if self.source == "device":
            self.frames = torch.rand((n, b, h, w, 3), **kw).to(self.dtype)
            self.masks = (torch.rand((n, b, h, w, 1), **kw) > 0.8
                          ).to(self.dtype)
        elif self.source == "pinned_u8":
            pin = self.device.type == "cuda"
            host = lambda t: t.cpu().pin_memory() if pin else t.cpu()
            self.frames = host(torch.randint(0, 256, (n, b, h, w, 3),
                                             dtype=torch.uint8, **kw))
            self.masks = host((torch.rand((n, b, h, w, 1), **kw) > 0.8
                               ).to(torch.uint8))
        else:
            raise ValueError(f"source {self.source!r}: want 'device' or "
                             "'pinned_u8'")
        self.dpb0 = {
            "frame": torch.rand((b, h, w, 3), **kw).to(self.dtype),
            "feature": (torch.randn((b, h // 8, w // 8, self.cfg.ch_d), **kw)
                        * 0.1).to(self.dtype)}

    # -- the timed path ----------------------------------------------------

    def start(self) -> Dict[str, torch.Tensor]:
        """The DPB a GOP starts from, packed as the model carries it."""
        from ssgvc_tpu_torch.ops.pixel import pixel_unshuffle

        return {"frame": pixel_unshuffle(self.dpb0["frame"], self.r),
                "feature": self.dpb0["feature"]}

    def _raw(self, t: int):
        """Frame and mask ``t`` of every stream on the card, in the
        model's dtype: as drawn, or copied from pinned memory and
        converted."""
        if self.source == "device":
            return self.frames[t], self.masks[t]
        x = self.frames[t].to(self.device, non_blocking=True)
        m = self.masks[t].to(self.device, non_blocking=True)
        return x.float().mul_(1.0 / 255.0).to(self.dtype), m.to(self.dtype)

    def step(self, t: int, state, qp: int):
        """Queue frame ``t`` of the GOP: (its outputs, the next DPB)."""
        from ssgvc_tpu_torch.ops.pixel import pixel_unshuffle

        x, m = self._raw(t)
        x, m = pixel_unshuffle(x, self.r), pixel_unshuffle(m, self.r)
        with torch.no_grad(), ctl.env(self.control):
            out = self.model(x, qp, state, after_i=False, mask=m)
        return out, out["dpb"]

    @staticmethod
    def bpp(out) -> torch.Tensor:
        return out["bpp"]

    @staticmethod
    def keep(out) -> Dict[str, torch.Tensor]:
        return {"frame": out["dpb"]["frame"],
                "feature": out["dpb"]["feature"], "bpp": out["bpp"]}

    def release(self) -> None:
        """Drop the program's model: what the reference needs is the
        benchmark's weights and inputs."""
        del self.model

    # -- the comparison ----------------------------------------------------

    def _ref_input(self, t: int, b: int):
        """Frame ``t`` of stream ``b`` and its mask, packed, in fp32, from
        the benchmark's own data."""
        x = self.frames[t, b:b + 1].to(self.device)
        m = self.masks[t, b:b + 1].to(self.device)
        if self.source == "pinned_u8":
            x = x.float().mul_(1.0 / 255.0)
        return (ref_unshuffle(x.float(), self.r),
                ref_unshuffle(m.float(), self.r))

    def reference(self, kept: List[Dict[str, torch.Tensor]], qp: int
                  ) -> Dict[str, List[float]]:
        """Each reading of each frame of the kept GOP, the worst stream's
        at each position. The reference codes each frame from the DPB the
        program carried into it (the first from the drawn DPB): rounding
        decisions that flip between two precisions make two free-running
        GOPs part within a few frames, whatever the precision, so each
        frame is judged from the program's own state."""
        per = {k: [0.0] * len(kept) for k in READINGS}
        for b in range(self.streams):
            dpb = {"frame": ref_unshuffle(self.dpb0["frame"][b:b + 1]
                                          .float(), self.r),
                   "feature": self.dpb0["feature"][b:b + 1].float()}
            for t, k in enumerate(kept):
                x, m = self._ref_input(t, b)
                r = ref.forward(self.sd, x, m, qp, dpb, self.r)
                got = {"frame": k["frame"][b:b + 1].float(),
                       "feature": k["feature"][b:b + 1].float()}
                recon = ref.reconstruct(self.sd, got["feature"], qp)
                read = {
                    "frame_mse": float(torch.mean(
                        (got["frame"] - r["frame"]) ** 2)),
                    "recon_mse": float(torch.mean(
                        (got["frame"] - recon) ** 2)),
                    "feature_rel": float(
                        torch.linalg.vector_norm(got["feature"]
                                                 - r["feature"])
                        / torch.linalg.vector_norm(r["feature"])),
                    "bpp_rel": float(abs(k["bpp"][b].float() - r["bpp"][0])
                                     / r["bpp"][0])}
                for key, v in read.items():
                    ctl.worst(per, key, t, v)
                dpb = got
                del r, recon
        return per

    # -- the yardstick -----------------------------------------------------

    def count(self) -> Count:
        """Products of one frame of one stream, on the meta device."""
        from ssgvc_tpu_torch.config import DMCConfig
        from ssgvc_tpu_torch.models.dmc import DMC

        m = dict(self.config["model"])
        cfg = DMCConfig.variant(m.pop("variant"), **m)
        shapes = {k: v.shape for k, v in
                  DMC(cfg, device="meta").state_dict().items()}
        sd = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
        hp, wp = self.h // self.r, self.w // self.r
        e = lambda c: torch.empty((1, hp, wp, c), device="meta")
        return count(lambda: ref.forward(
            sd, e(3 * self.r ** 2), e(self.r ** 2), 0,
            {"frame": e(3 * self.r ** 2), "feature": e(cfg.ch_d)}, self.r))

