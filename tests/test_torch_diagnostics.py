"""The port's P-frame diagnostics (ssgvc_tpu_torch/experiments/diag_pframe.py,
probes/probe_latent_liveness.py, probes/probe_dist_only.py) against the JAX
package on the CPU, at the rd-tiny widths and 64 px (the smallest frame
both packages' DMC take: y at 4x4, the hyper path at 1x1), the weights drawn
once and carried across by utils/weights.py. The JAX side is composed from
ssgvc_tpu classes with the scripts' own lines: the scripts themselves read
orbax checkpoints, and probe_dist_only trains at import.

Tolerances: PSNR within 1e-4 dB, bpp at rtol 5e-3 (the rate estimate's known
ill-conditioning, ROADMAP section 3), the fractions of live latent positions
within one position, the copy-previous PSNR exactly, lambda and the copy
baseline bit for bit, one eval-mode GOP loss at rtol 1e-5. The
distortion-only probe's tests are in test_torch_diagnostics_dist.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import DMC_HEADS, DMCI_HEADS
from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
from ssgvc_tpu.config import DMCIConfig as JaxDMCIConfig
from ssgvc_tpu.data.dataset import SyntheticClipDataset as JaxClips
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu.models.dmci import DMCI as JaxDMCI
from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
from ssgvc_tpu_torch.experiments import diag_pframe, rd_full, restore_fitting
from ssgvc_tpu_torch.experiments.probes import probe_dist_only as dist_only
from ssgvc_tpu_torch.experiments.probes import probe_latent_liveness as live
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.utils.checkpoint import save_checkpoint
from torch_port_helpers import DMCI_RD_TINY, DMCI_TINY, RD_TINY, TINY, \
    drawn_params
from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PSNR_DB = 1e-4
BPP_RTOL = 5e-3
GLOBALS = ("MID_DMC", "MID_DMCI", "PROFILE", "RECON_SKIP", "CKPT_EXTRA",
           "DEVICE")


@pytest.fixture
def port_cpu(monkeypatch, tmp_path):
    """rd_full's globals restored after the test, the working directory
    ``tmp_path``, one thread (heavy tests under six test processes)."""
    for name in GLOBALS:
        monkeypatch.setattr(rd_full, name, getattr(rd_full, name))
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield monkeypatch
    torch.set_num_threads(threads)


def _models(variant="performance", seed=3):
    """The rd-tiny DMCI and DMC of ``variant`` with drawn weights: (port
    DMCI, port DMC, DMCI flax params, DMC flax params), copies of the
    port's tensors."""
    dmci = DMCI(DMCIConfig(**DMCI_RD_TINY), device="cpu")
    dmc = DMC(DMCConfig.variant(variant, **RD_TINY), device="cpu")
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)
    pi = copy(drawn_params(dmci, seed, DMCI_HEADS))
    pp = copy(drawn_params(dmc, seed + 1, DMC_HEADS))
    return dmci, dmc, pi, pp


def _write_checkpoint(path, dmci, dmc):
    save_checkpoint(path, {"params_p": dmc.state_dict(),
                           "params_i": dmci.state_dict()})


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float32)
                         - np.asarray(b, np.float32)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-10))


def _jax_diag_row(jdmci, jdmc, pi, pp, frames, masks, qp):
    """experiments/diag_pframe.py:56-86 for one clip."""
    res = frames.shape[1]
    x0 = jnp.asarray(frames[0])[None]
    out = jdmci.apply({"params": pi}, x0, jnp.int32(qp), train=False)
    i_rec = np.asarray(out["dpb"]["frame"][0])
    row = {"I": _psnr(frames[0], i_rec), "I_bpp": float(out["bpp"][0])}
    dpb = {"frame": out["dpb"]["frame"],
           "feature": jnp.zeros((1, res // 8, res // 8, jdmc.cfg.ch_d),
                                jnp.float32)}
    for t in range(1, frames.shape[0]):
        x = jnp.asarray(frames[t])[None]
        m = jnp.asarray(masks[t])[None]
        o = jdmc.apply({"params": pp}, x, jnp.int32(qp), dpb,
                       after_i=(t == 1), mask=m, train=False)
        row[f"P{t}"] = _psnr(frames[t], np.asarray(o["dpb"]["frame"][0]))
        row[f"P{t}_bpp"] = float(o["bpp"][0])
        od = {"frame": jnp.asarray(frames[t - 1])[None],
              "feature": dpb["feature"]}
        oo = jdmc.apply({"params": pp}, x, jnp.int32(qp), od,
                        after_i=(t == 1), mask=m, train=False)
        row[f"P{t}_oracle"] = _psnr(frames[t],
                                    np.asarray(oo["dpb"]["frame"][0]))
        row[f"copy{t}"] = _psnr(frames[t], frames[t - 1])
        dpb = o["dpb"]
    return row


def _check_row(got, want, what):
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        if k.startswith("copy"):
            assert got[k] == w, (what, k)
        elif k.endswith("bpp"):
            np.testing.assert_allclose(got[k], w, rtol=BPP_RTOL,
                                       err_msg=f"{what} {k}")
        else:
            assert abs(got[k] - w) <= PSNR_DB, (what, k, got[k], w)


def test_diag_rows_equal_jax(port_cpu):
    """diag_pframe's rows on 2 of its pinned clips at QP 32 (I, each
    P-frame on the model's and on the oracle DPB, copy-previous, bpp)
    against the JAX DMCI / DMC ``apply`` with train=False, composed as the
    JAX script composes them, on the same weights; the pinned clips equal
    the JAX script's."""
    dmci, dmc, pi, pp = _models()
    clips = rd_full.eval_clip_set(64, 2)
    jds = JaxClips(num_clips=8, seq_len=4, crop_size=64, seed=777,
                   texture="smooth")
    jclips = [jds.__getitem__(i, rng=np.random.default_rng(900 + i))
              for i in range(2)]
    jdmci = JaxDMCI(JaxDMCIConfig(**DMCI_RD_TINY))
    jdmc = JaxDMC(JaxDMCConfig.variant("performance", **RD_TINY))
    got, want = [], []
    for (frames, masks), (jf, jm) in zip(clips, jclips):
        assert np.array_equal(frames, jf) and np.array_equal(masks, jm)
        got.append(diag_pframe.clip_row(dmci, dmc, frames, masks, 32))
        want.append(_jax_diag_row(jdmci, jdmc, pi, pp, jf, jm, 32))
        _check_row(got[-1], want[-1], f"clip {len(got) - 1}")
    agg = diag_pframe.aggregate(got)
    _check_row(agg, {k: float(np.mean([r[k] for r in want]))
                     for k in want[0]}, "mean")


def _jax_run(jdmc, pp, frames, masks, qp, dpb_frame):
    """run() of experiments/probes/probe_latent_liveness.py:80-96."""
    x = jnp.asarray(frames[1])[None]
    m = jnp.asarray(masks[1])[None]
    dpb = {"frame": jnp.asarray(dpb_frame)[None],
           "feature": jnp.zeros((1, 8, 8, jdmc.cfg.ch_d), jnp.float32)}
    out, inter = jdmc.apply(
        {"params": pp}, x, jnp.int32(qp), dpb, after_i=True, mask=m,
        train=False, capture_intermediates=True, mutable=["intermediates"])
    y = np.asarray(inter["intermediates"]["encoder"]["__call__"][0])
    z = (np.asarray(inter["intermediates"]["hyper_encoder"]["__call__"][0])
         * np.asarray(pp["z_gain"], np.float32))
    return (np.asarray(out["dpb"]["frame"][0]), float(out["bpp"][0]),
            float(np.mean(np.round(y) != 0)),
            float(np.mean(np.round(z) != 0)), y.size, z.size)


def test_liveness_rows_equal_jax(port_cpu):
    """The liveness probe's table (its run() with y and z taken by forward
    hooks) against the JAX probe's run() with capture_intermediates on the
    same weights and clips: alive_y / alive_z within one latent position,
    bpp at rtol 5e-3, PSNR, dpb_dep and inp_dep within 1e-4 dB."""
    _, dmc, _, pp = _models(seed=5)
    clips = rd_full.eval_clip_set(64, 2)
    rows = live.liveness_rows(dmc, clips)
    jdmc = JaxDMC(JaxDMCConfig.variant("performance", **RD_TINY))
    (f0, m0), (f1, m1) = clips
    assert list(rows) == [8, 32, 56]
    for qp, r in rows.items():
        r0, bpp, ay, az, ny, nz = _jax_run(jdmc, pp, f0, m0, qp, f0[0])
        r0z = _jax_run(jdmc, pp, f0, m0, qp, np.zeros_like(f0[0]))[0]
        r1 = _jax_run(jdmc, pp, f1, m1, qp, f1[0])[0]
        p = _psnr(f0[1], r0)
        assert abs(r["alive_y"] - ay) <= 1.0 / ny, (qp, r["alive_y"], ay)
        assert abs(r["alive_z"] - az) <= 1.0 / nz, (qp, r["alive_z"], az)
        np.testing.assert_allclose(r["bpp"], bpp, rtol=BPP_RTOL)
        for k, w in (("psnr", p), ("dpb_dep", p - _psnr(f0[1], r0z)),
                     ("inp_dep", _psnr(r0, r1))):
            assert abs(r[k] - w) <= PSNR_DB, (qp, k, r[k], w)
        assert 0.0 < r["alive_y"] <= 1.0 and 0.0 < r["alive_z"] <= 1.0


@pytest.mark.parametrize("who", ["diag_pframe", "probe_dist_only"])
def test_restore_refuses_a_checkpoint_of_other_widths(port_cpu, who):
    """A checkpoint of the tiny widths where the rd-tiny one belongs is
    refused with its path named, and the model it was checked against is
    left as it was."""
    small_i = DMCI(DMCIConfig(**DMCI_TINY), device="cpu")
    small_p = DMC(DMCConfig.variant("performance", **TINY), device="cpu")
    path = diag_pframe.tiny_ckpt_path("performance")
    Path(path).parent.mkdir(parents=True)
    _write_checkpoint(path, small_i, small_p)
    if who == "diag_pframe":
        with pytest.raises(ValueError, match=re.escape(path)):
            diag_pframe.restore_models("performance", "cpu")
        return
    tr = dist_only.trainer("plain", 10, "cpu")
    before = {k: v.clone() for k, v in tr.dmci.state_dict().items()}
    with pytest.raises(ValueError, match=re.escape(path) + ".*params_i"):
        restore_fitting(path, params_i=tr.dmci)
    with pytest.raises(ValueError, match=re.escape(path)):
        dist_only.main(["--device=cpu", "plain", "1"])
    after = tr.dmci.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before.items())


def test_diag_pframe_main_prints_the_jax_lines(port_cpu, capsys):
    """diag_pframe.main at --res 64 on a checkpoint written with
    save_checkpoint: the JAX script's lines for each QP; the I-frame row
    equals the DMCI's, the copy-previous PSNR numpy's."""
    dmci, dmc, _, _ = _models(variant="plain", seed=11)
    path = diag_pframe.tiny_ckpt_path("plain")
    Path(path).parent.mkdir(parents=True)
    _write_checkpoint(path, dmci, dmc)
    report = diag_pframe.main(["--device=cpu", "--res", "64", "--variant",
                               "plain"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 * 6
    num = r"-?\d+\.\d+"
    for i, qp in enumerate((8, 32, 56)):
        block = lines[6 * i:6 * i + 6]
        assert block[0] == f"qp={qp} res=64 variant=plain"
        assert re.fullmatch(rf"  I {{10}}\s*{num}", block[1]), block[1]
        assert re.fullmatch(rf"  I_bpp {{6}}\s*{num}", block[2]), block[2]
        for t in (1, 2, 3):
            assert re.fullmatch(
                rf"  P{t}: model\s+{num}  oracle-dpb\s+{num}  "
                rf"copy-prev\s+{num}  bpp {num}", block[2 + t]), block[2 + t]
        row = report[qp]
        assert all(np.isfinite(v) for v in row.values())
        clips = rd_full.eval_clip_set(64, diag_pframe.N_CLIPS)
        for t in (1, 2, 3):
            want = np.mean([_psnr(f[t], f[t - 1]) for f, _ in clips])
            assert row[f"copy{t}"] == pytest.approx(want, abs=1e-6)
        assert block[1] == f"  {'I':10s} {row['I']:8.3f}"


def test_probe_latent_liveness_main_prints_the_jax_lines(port_cpu, capsys):
    """probe_latent_liveness.main at 2 steps: a step line for each step
    (the JAX script prints step 0 and the last), then the table's header
    and one row a QP with alive fractions in [0, 1] and finite numbers."""
    out = live.main(["--device=cpu", "2"])
    lines = capsys.readouterr().out.splitlines()
    num = r"-?\d+\.\d+"
    assert [ln.split(":")[0] for ln in lines[:2]] == ["step 0", "step 1"]
    for ln in lines[:2]:
        assert re.fullmatch(rf"step \d: loss {num} bpp {num} psnr {num} "
                            rf"\(\d+s\)", ln), ln
    assert lines[2:4] == ["", "qp |   bpp  | psnr | alive_y | alive_z | "
                              "dpb_dep | inp_dep"]
    assert len(lines) == 7
    for ln, qp in zip(lines[4:], (8, 32, 56)):
        assert re.fullmatch(rf"\s?{qp} \| {num} \|\s+{num} \|\s+{num} \|"
                            rf"\s+{num} \|\s+[+-]{num} \|\s+{num}", ln), ln
        r = out["rows"][qp]
        assert 0 <= r["alive_y"] <= 1 and 0 <= r["alive_z"] <= 1
        assert all(np.isfinite(v) for v in r.values())
    assert out["steps"] == 2 and [t["step"] for t in out["train"]] == [0, 1]
