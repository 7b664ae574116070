#!/usr/bin/env python3
"""Does the JAX package's DPB blow up as the port's does, on the same
weights? (ROADMAP §3, F6.)

    JAX_PLATFORMS=cpu python experiments/f6_dpb_growth.py [--frames 9]

On the CPU, in seconds; it imports both packages, as the tests do.

1. Train the port's tiny profile (fp32, the default ``TrainConfig``
   otherwise: accumulation 8, AdamW) 10 ``train_step``s through
   ``Trainer.fit`` on ``synth_batch`` clips of B=2, 64x64, T=4, seeds
   100-109.
2. Carry the P-frame weights into the JAX ``DMC`` through
   ``utils/weights.flax_from_state_dict``.
3. Roll one clip (``synth_batch`` seed 999, 64x64) of ``--frames``
   P-frames at QP 30, ``train=False``, both packages starting from the
   port's I-frame reconstruction and a zero feature, three ways:
   (a) free-running in each package;
   (b) teacher-forced: the port fed the JAX package's DPB at each frame;
   (c) the JAX package against itself with the DPB (frame and feature)
       scaled by (1 + 2^-23): how much one ulp of input moves each step;
   (d) the same for the port against itself, on (b)'s input.
   Per frame it prints both packages' DPB feature max |.| and finiteness,
   (a)'s relative difference, (b)'s, (c)'s and (d)'s: max |a - b| /
   max |b| of the output feature.
4. At the first frame where (b) exceeds 1e-3, both packages'
   ``layer_forensics`` on that frame's identical inputs (and the JAX one
   on the perturbed DPB): per module in the port's call order, the
   relative norm and max |.| differences port-vs-JAX beside
   perturbed-vs-JAX, and the first module whose difference exceeds K times
   what the perturbation gives (and 1e-6), if any: among all modules, and
   among those that run before the quantized latent y_hat (every module
   but the decoder and the reconstruction net, which a flipped rounding of
   y moves past any such bound).

The last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(ch_d=16, ch_y=8, ch_z=8, ch_recon=16)
TRAIN_SEEDS = range(100, 110)
CLIP_SEED, QP, HW = 999, 30, 64
ULP = 2.0 ** -23
#: a module parts when its difference exceeds K x the perturbation's
K = 10.0
FLOOR = 1e-6
#: the modules fed by the quantized latent y_hat (flax path prefixes)
AFTER_Y_HAT = ("decoder/", "recon_generation_net/")


def train_tiny(steps_seeds=TRAIN_SEEDS, b=2, hw=HW, t=4):
    """The port's tiny Trainer after ``len(steps_seeds)`` fit steps on the
    CPU."""
    import torch

    from ssgvc_tpu_torch.config import TrainConfig
    from ssgvc_tpu_torch.data.device_synth import synth_batch
    from ssgvc_tpu_torch.training.trainer import Trainer

    tr = Trainer(TrainConfig(model_profile="tiny", precision="32"),
                 total_iters=len(steps_seeds), device="cpu")
    batches = (synth_batch(torch.Generator().manual_seed(s), batch=b,
                           size=hw, seq_len=t, device="cpu")
               for s in steps_seeds)
    tr.fit(batches, steps=len(steps_seeds), seed=0)
    return tr


def clip(frames_n, seed=CLIP_SEED, hw=HW):
    """(frames, masks) of one synthetic clip: I-frame + ``frames_n``
    P-frames, numpy (T, hw, hw, C)."""
    import torch

    from ssgvc_tpu_torch.data.device_synth import synth_batch

    d = synth_batch(torch.Generator().manual_seed(seed), batch=1, size=hw,
                    seq_len=frames_n + 1, device="cpu")
    return d["frames"][0].numpy(), d["masks"][0].numpy()


class JittedApply:
    """A flax module whose ``apply`` runs jitted, its non-array keywords
    static: the JAX ``layer_forensics`` then compiles its
    ``capture_intermediates`` forward once, as the roll's P-frame step is,
    rather than dispatching it op by op."""

    def __init__(self, model):
        self.model = model
        self._jits = {}

    def apply(self, variables, *args, **kwargs):
        import jax

        static = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in kwargs.items() if not hasattr(v, "shape")}
        arrays = {k: v for k, v in kwargs.items() if hasattr(v, "shape")}
        key = tuple(sorted(static.items()))
        if key not in self._jits:
            self._jits[key] = jax.jit(lambda v, a, kw: self.model.apply(
                v, *a, **kw, **static))
        return self._jits[key](variables, args, arrays)


class Packages:
    """The same P-frame weights in the port's DMC and the JAX package's,
    one P-frame call each on numpy DPBs."""

    def __init__(self, trainer):
        import jax
        import jax.numpy as jnp

        from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
        from ssgvc_tpu.models.dmc import DMC as JaxDMC
        from ssgvc_tpu_torch.utils.weights import flax_from_state_dict

        self.port = trainer.dmc.eval()
        self.dmci = trainer.dmci
        self.jmodel = JaxDMC(JaxDMCConfig.variant("performance", **TINY))
        self.params = flax_from_state_dict(self.port.state_dict())
        self._jnp = jnp
        self._jit = {
            a: jax.jit(lambda p, x, m, f, g, a=a: self.jmodel.apply(
                {"params": p}, x, jnp.int32(QP), {"frame": f, "feature": g},
                after_i=a, mask=m, train=False)) for a in (True, False)}

    def iframe(self, x):
        import torch

        with torch.no_grad():
            out = self.dmci(torch.from_numpy(x[None]), QP, train=False)
        return out["dpb"]["frame"][0].numpy()

    def port_step(self, x, m, dpb, after_i):
        import torch

        t = lambda a: torch.from_numpy(np.array(a[None]))
        with torch.no_grad():
            out = self.port(t(x), QP, {"frame": t(dpb["frame"]),
                                       "feature": t(dpb["feature"])},
                            after_i=after_i, mask=t(m), train=False)
        return {k: v[0].numpy() for k, v in out["dpb"].items()}

    def jax_step(self, x, m, dpb, after_i):
        a = lambda v: self._jnp.asarray(v[None])
        out = self._jit[after_i](self.params, a(x), a(m), a(dpb["frame"]),
                                 a(dpb["feature"]))
        return {k: np.asarray(v[0]) for k, v in out["dpb"].items()}

    def forensics(self, x, m, dpb, after_i, port=True):
        """(port stats and its modules' call order, or the JAX stats)."""
        import torch

        if port:
            from ssgvc_tpu_torch.utils.debug import layer_forensics

            order = []

            def seen(name):
                def hook(*_):
                    if name not in order:
                        order.append(name)
                return hook

            hooks = [mod.register_forward_hook(seen(name))
                     for name, mod in self.port.named_modules()]
            t = lambda a: torch.from_numpy(np.array(a[None]))
            try:
                stats = layer_forensics(
                    self.port, t(x), QP, {"frame": t(dpb["frame"]),
                                          "feature": t(dpb["feature"])},
                    top_k=10 ** 6, after_i=after_i, mask=t(m), train=False)
            finally:
                for h in hooks:
                    h.remove()
            paths = ["/".join(n.split(".") + ["__call__"]) if n else
                     "__call__" for n in order]
            return stats, paths
        from ssgvc_tpu.utils.debug import layer_forensics

        a = lambda v: self._jnp.asarray(v[None])
        return layer_forensics(
            JittedApply(self.jmodel), {"params": self.params}, a(x), self._jnp.int32(QP),
            {"frame": a(dpb["frame"]), "feature": a(dpb["feature"])},
            top_k=10 ** 6, after_i=after_i, mask=a(m), train=False)


def rel(a, b):
    """max |a - b| / max |b| (inf where b is not finite)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return float("inf")
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def feature_max(dpb):
    f = dpb["feature"]
    return float(np.abs(f).max()) if np.isfinite(f).all() else float("nan")


def roll(pk, frames, masks):
    """Per P-frame: the free-running feature max of both packages and
    (a)-(c). Returns (rows, the JAX DPB before each frame)."""
    start = {"frame": pk.iframe(frames[0]),
             "feature": np.zeros((HW // 8, HW // 8, TINY["ch_d"]),
                                 np.float32)}
    dp, dj = dict(start), dict(start)
    rows, jax_in = [], []
    for t in range(1, len(frames)):
        after_i = t == 1
        x, m = frames[t], masks[t]
        jax_in.append(dj)
        forced = pk.port_step(x, m, dj, after_i)
        up = {k: v * np.float32(1 + ULP) for k, v in dj.items()}
        pert = pk.jax_step(x, m, up, after_i)
        pert_port = pk.port_step(x, m, up, after_i)
        dp = pk.port_step(x, m, dp, after_i)
        dj_next = pk.jax_step(x, m, dj, after_i)
        rows.append(dict(
            frame=t, port_max=feature_max(dp), jax_max=feature_max(dj_next),
            port_finite=bool(np.isfinite(dp["feature"]).all()),
            jax_finite=bool(np.isfinite(dj_next["feature"]).all()),
            free_rel=rel(dp["feature"], dj_next["feature"]),
            forced_rel=rel(forced["feature"], dj_next["feature"]),
            forced_frame_rel=rel(forced["frame"], dj_next["frame"]),
            ulp_rel=rel(pert["feature"], dj_next["feature"]),
            port_ulp_rel=rel(pert_port["feature"], forced["feature"])))
        dj = dj_next
    return rows, jax_in


def part(stats_p, order, stats_j, stats_jp):
    """Per module shared by both packages, in the port's call order: the
    relative norm and max |.| difference port-vs-JAX and
    perturbed-vs-JAX, and whether it runs before y_hat; then the first
    module whose difference exceeds K x the perturbation's (and FLOOR),
    and the first such before y_hat, each None if there is none."""
    d = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    rows = []
    for path in order:
        if path not in stats_p or path not in stats_j:
            continue
        p, j, jp = stats_p[path], stats_j[path], stats_jp[path]
        rows.append(dict(
            module=path, before_y_hat=not path.startswith(AFTER_Y_HAT),
            port=max(d(p["norm"], j["norm"]), d(p["max_abs"], j["max_abs"])),
            ulp=max(d(jp["norm"], j["norm"]),
                    d(jp["max_abs"], j["max_abs"]))))
    parted = [r for r in rows if r["port"] > max(K * r["ulp"], FLOOR)]
    first = next((r["module"] for r in parted), None)
    first_before = next((r["module"] for r in parted if r["before_y_hat"]),
                        None)
    return rows, first, first_before


def forensics_at(pk, frames, masks, jax_in, t):
    """:func:`part` of both packages' ``layer_forensics`` on P-frame
    ``t``'s inputs from the JAX roll, beside the JAX package on the same
    inputs with the DPB scaled by 1 + 2^-23."""
    x, m, dpb, after_i = frames[t], masks[t], jax_in[t - 1], t == 1
    stats_p, order = pk.forensics(x, m, dpb, after_i)
    stats_j = pk.forensics(x, m, dpb, after_i, port=False)
    stats_jp = pk.forensics(x, m, {k: v * np.float32(1 + ULP)
                                   for k, v in dpb.items()}, after_i,
                            port=False)
    return (len(stats_p), len(stats_j)) + part(stats_p, order, stats_j,
                                               stats_jp)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=9)
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    tr = train_tiny()
    t_train = time.perf_counter() - t0
    pk = Packages(tr)
    frames, masks = clip(args.frames)
    rows, jax_in = roll(pk, frames, masks)
    print(f"tiny profile trained {len(TRAIN_SEEDS)} steps in {t_train:.1f} s;"
          f" clip seed {CLIP_SEED}, {args.frames} P-frames at QP {QP}, "
          f"{HW}x{HW}")
    print(f"{'frame':>5} {'port max':>12} {'jax max':>12} {'finite':>7} "
          f"{'(a) free':>10} {'(b) forced':>11} {'(c) 1 ulp':>10} "
          f"{'(d) port':>10}")
    for r in rows:
        print(f"{r['frame']:>5} {r['port_max']:>12.6g} {r['jax_max']:>12.6g} "
              f"{str(r['port_finite'])[0]}/{str(r['jax_finite'])[0]:>5} "
              f"{r['free_rel']:>10.3e} {r['forced_rel']:>11.3e} "
              f"{r['ulp_rel']:>10.3e} {r['port_ulp_rel']:>10.3e}")
    result = dict(rows=rows, train_s=t_train, k=K)
    over = [r for r in rows if r["forced_rel"] > 1e-3]
    if over:
        t = over[0]["frame"]
        n_p, n_j, mods, first, first_before = forensics_at(
            pk, frames, masks, jax_in, t)
        print(f"forensics at frame {t}: {n_p} port modules, {n_j} JAX, "
              f"{len(mods)} shared; relative norm / max |.| difference, "
              f"port vs JAX beside 1-ulp JAX vs JAX (* fed by y_hat):")
        for r in mods:
            print(f"  {r['module']:<48}{' ' if r['before_y_hat'] else '*'} "
                  f"{r['port']:.3e}  {r['ulp']:.3e}")
        print(f"first module past {K:g} x the 1-ulp difference (and "
              f"{FLOOR:g}): {first}; before y_hat: {first_before}")
        result.update(forensics_frame=t, modules=mods, first_parting=first,
                      first_parting_before_y_hat=first_before)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
