"""Faults planted under the timed path, by name: what the comparison that
decides ``correct`` has to catch. Each takes the codec adapter after
set-up (``cell.run``'s ``wrap``) and breaks its step or the program's
model underneath it; the benchmark's own runs plant none.

  * ``unchanged``: a step that returns its state unchanged;
  * ``half_batch``: half of the batch left out, its outputs stood in for
    by the rest's;
  * ``altered``: a decoded frame altered where it is produced;
  * ``no_bits_z``: the rate of the hyper latent left out of the bpp;
  * ``no_sigma_floor``: the rate's floor on the prior's sigma removed.

The last two leave every decoded frame as it is: only the rate
(``bpp_rel``) can catch them. ``benchmark/tests/test_bench_faults.py``
plants each on the CPU; ``readings.py --fault`` reads each on the card at
the cell's own size.
"""

from __future__ import annotations

import dataclasses

import torch


def unchanged(codec) -> None:
    step = codec.step

    def broken(t, state, qp):
        out, _ = step(t, state, qp)
        return dict(out, dpb=state), state

    codec.step = broken


def half_batch(codec) -> None:
    step, model = codec.step, codec.model

    def half(x, qp, dpb, **kw):
        h = x.shape[0] // 2
        kw["mask"] = kw["mask"][:h]
        out = model(x[:h], qp, {k: v[:h] for k, v in dpb.items()}, **kw)
        two = lambda t: torch.cat([t, t], dim=0)
        return dict(out, bpp=two(out["bpp"]), dpb={
            k: two(v) for k, v in out["dpb"].items()})

    def broken(t, state, qp):
        codec.model = half
        try:
            return step(t, state, qp)
        finally:
            codec.model = model

    codec.step = broken


def altered(codec) -> None:
    step = codec.step

    def broken(t, state, qp):
        out, state = step(t, state, qp)
        if t == codec.group - 1:
            frame = out["dpb"]["frame"].clone()
            frame[0] = torch.clamp(frame[0] + 0.05, 0.0, 1.0)
            out = dict(out, dpb=dict(out["dpb"], frame=frame))
        return out, state

    codec.step = broken


def no_bits_z(codec) -> None:
    codec.model.bit_estimator_z.bits = (
        lambda z, index: torch.zeros_like(z, dtype=torch.float32))


def no_sigma_floor(codec) -> None:
    codec.model.cfg = dataclasses.replace(codec.model.cfg,
                                          bits_sigma_floor=0.0)


FAULTS = {f.__name__: f for f in (unchanged, half_batch, altered,
                                  no_bits_z, no_sigma_floor)}
