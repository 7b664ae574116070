"""The port stands alone: no module of ssgvc_tpu_torch, and not
chip_smoke.py, imports JAX, flax or the JAX package, nor loads its native
coder; its entry points target the card unless asked for the CPU, with no
fallback, and take bfloat16 and float32 there (any other dtype raises)."""

import ast
import os
from pathlib import Path

import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ssgvc_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((ROOT / "ssgvc_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


TRAINING_MODULES = ("ops.dcb_grad", "data.device_synth", "training.loss",
                    "training.schedule", "training.optimizers",
                    "training.calibrate", "training.trainer", "config",
                    "training.evaluate", "ops.dcb", "ops.dcb_chain")
#: the training entry point from data on disk
DATA_MODULES = ("utils.transforms", "data.tfrecord", "data.waymo_proto",
                "data.lidar", "data.build_cache", "data.video_transform",
                "data.vimeo", "data.dataset", "utils.logging",
                "utils.torch_import", "utils.checkpoint", "utils.visualize",
                "trainer_seg_video_model")
#: the image trainer and the coding command lines
CLI_MODULES = ("trainer_image_model", "utils.video_io", "scripts.encode",
               "scripts.decode")
#: the debug and profiling tools and the graft entry
TOOL_MODULES = ("utils.debug", "utils.profiling", "utils.flops",
                "graft_entry")
#: data-parallel training and the row-sharded P-frame
PARALLEL_MODULES = ("parallel.mesh", "parallel.spatial")
#: the opt-in experiments: the int8 conv, the patch convs, the blocks
EXPERIMENT_MODULES = ("ops.qconv", "ops.pixel", "layers.blocks")
#: the RD experiment harness
RD_MODULES = ("experiments.rd_keep_best", "experiments.rd_full",
              "experiments.rd_tpu", "experiments.rd_eval",
              "experiments.rd_continue", "experiments.rd_demo",
              "experiments.rd_trajectory", "experiments.rd_report",
              "experiments.mask_train_phase", "experiments.mask_prop_value",
              "experiments.e2e_waymo_format", "experiments.diag_pframe",
              "experiments.probes.probe_latent_liveness",
              "experiments.probes.probe_dist_only")
#: the measuring scripts
MEASURE_MODULES = ("experiments.profile_stages", "experiments.bench_sweep",
                   "experiments.trace_bench", "experiments.bench_coded",
                   "experiments.bench_rans", "experiments.smoke_128px",
                   "experiments.probe_int8", "bench")


ALL_MODULES = (TRAINING_MODULES + DATA_MODULES + CLI_MODULES + TOOL_MODULES
               + PARALLEL_MODULES + EXPERIMENT_MODULES + RD_MODULES
               + MEASURE_MODULES)


@pytest.fixture(scope="module")
def imports_without_jax():
    """{module: "" or the error its import raised}: every module of
    ALL_MODULES imported in turn in one fresh interpreter, with JAX, flax,
    optax and the JAX package made unimportable; then any of them found in
    sys.modules. A blocked import raises inside the module that tried it,
    whichever module imported it first, so one interpreter judges each
    module as one of its own would (and starts torch once, not once a
    module)."""
    import json
    import subprocess
    import sys

    code = (
        "import importlib, importlib.abc, json, sys, traceback\n"
        f"BAD = {FORBIDDEN!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in BAD:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "out = {}\n"
        f"for m in {list(ALL_MODULES)!r}:\n"
        "    try:\n"
        "        importlib.import_module('ssgvc_tpu_torch.' + m)\n"
        "        out[m] = ''\n"
        "    except Exception:\n"
        "        out[m] = traceback.format_exc()\n"
        "    bad = [k for k in sys.modules if k.split('.')[0] in BAD]\n"
        "    if bad:\n"
        "        out[m] += 'loaded: %s' % bad\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", ALL_MODULES)
def test_training_modules_import_without_jax(module, imports_without_jax):
    """Each module of the training path imports with JAX, flax, optax and
    the JAX package made unimportable, and loads none of them."""
    assert imports_without_jax[module] == "", imports_without_jax[module]


def test_port_never_reaches_the_jax_packages_coder():
    """The port's rANS coder is its own csrc/rans.cpp, built into its own
    _build/: no port file names the JAX package's native directory or
    library."""
    files = [p for p in sorted((ROOT / "ssgvc_tpu_torch").rglob("*"))
             if p.suffix in (".py", ".cpp", ".cu", ".cuh")]
    files.append(ROOT / "chip_smoke.py")
    bad = [f.relative_to(ROOT) for f in files
           if any(s in f.read_text() for s in ("ssgvc_tpu/native",
                                              "native/build", "librans.so"))]
    assert not bad, bad
    from ssgvc_tpu_torch.coding import rans
    from ssgvc_tpu_torch.ops import _build

    lib = Path(rans.get_lib()._name).resolve()
    assert lib.parent == _build.BUILD_DIR.resolve(), lib
    assert lib.name.startswith("librans-")


def test_dmc_defaults_to_the_card_and_never_falls_back():
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC

    widths = dict(ch_d=32, ch_y=16, ch_z=16, ch_recon=32)
    cfg = DMCConfig.variant("performance", dtype="bfloat16", **widths)
    if torch.cuda.is_available():
        model = DMC(cfg)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            DMC(cfg)
    model = DMC(DMCConfig.variant("performance", **widths), device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_dmci_defaults_to_the_card_and_never_falls_back():
    from ssgvc_tpu_torch.config import DMCIConfig
    from ssgvc_tpu_torch.models.dmci import DMCI

    cfg = DMCIConfig(enc_dec=48, N=32, z_channel=32, dtype="bfloat16")
    if torch.cuda.is_available():
        model = DMCI(cfg)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            DMCI(cfg)
    model = DMCI(DMCIConfig(enc_dec=48, N=32, z_channel=32), device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_card_refuses_float32_up_front():
    """The card takes float32 now (csrc/dcb_f32.cu): no model refuses it at
    construction any more, and the DepthConvBlock ops refuse only dtypes
    other than bfloat16 and float32, with a TypeError, before any kernel.
    (The name is the test's from when float32 was refused.) A CUDA-less
    host cannot build a CUDA model or tensor, so the rule itself and the
    sources are tested."""
    from ssgvc_tpu_torch.models import common
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
    from ssgvc_tpu_torch.ops import dcb_grad

    assert not hasattr(common, "check_card_dtype")
    for f in ("models/dmc.py", "models/dmci.py", "coding/codec.py"):
        assert "check_card_dtype" not in (ROOT / "ssgvc_tpu_torch" / f
                                          ).read_text(), f
    assert dcb_ops.KERNEL_DTYPES == (torch.bfloat16, torch.float32)
    for bad in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            dcb_grad._act_dtype("dw_fwd", bad)
    assert [dcb_grad._act_dtype("dw_fwd", d)
            for d in dcb_ops.KERNEL_DTYPES] == [0, 1]

    class Half:                     # a CUDA half tensor, as the ops see it
        device = torch.device("cuda")
        dtype = torch.float16

    x = Half()
    c = 16
    blk = tuple(torch.zeros(s) for s in ((c, c, 1, 1), (c,), (c, 1, 3, 3),
                                         (c,), (c, c, 1, 1), (c,),
                                         (4 * c, c, 1, 1), (4 * c,),
                                         (c, 2 * c, 1, 1), (c,)))
    with pytest.raises(TypeError, match="bfloat16"):
        dcb_ops.dcb(x, blk)
    with pytest.raises(TypeError, match="bfloat16"):
        chain_ops.dcb_chain(x, [blk, blk])
    for dtype in dcb_ops.KERNEL_DTYPES:
        with pytest.raises(TypeError):
            dcb_ops.check_input(x, "dcb", dcb_ops.MAX_CHANNELS, dtype)


@pytest.mark.parametrize("variant", ["performance", "plain", "old", "fast",
                                     "mask_prop"])
def test_every_variant_constructs_on_the_cpu(variant):
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC

    model = DMC(DMCConfig.variant(variant, ch_d=16, ch_y=8, ch_z=8,
                                  ch_recon=16), device="cpu")
    names = {k.split(".")[0] for k in model.state_dict()}
    assert ("mask_sft" in names) == (variant == "performance")
    assert ("mask_film" in names) == (variant in ("fast", "mask_prop"))
    assert ("mask_predictor" in names) == (variant == "mask_prop")
    assert hasattr(model.encoder, "conv3") == (variant == "old")


def test_parallel_defaults_to_the_card_and_never_falls_back():
    """A mesh's device is the card unless the caller asks for the CPU; a
    card-less host moving a batch there raises, and dryrun_multichip with
    no device wants n cards (it names device="cpu")."""
    from ssgvc_tpu_torch.graft_entry import dryrun_multichip
    from ssgvc_tpu_torch.parallel.mesh import make_mesh, shard_batch

    assert make_mesh().device.type == "cuda"
    assert make_mesh(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        return
    with pytest.raises((RuntimeError, AssertionError)):
        shard_batch(make_mesh(), {"x": torch.zeros(2)})
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dryrun_multichip(1)


def test_int8_conv_defaults_to_the_card_and_never_falls_back(monkeypatch):
    """Under SSGVC_INT8 a conv on the card launches ops/qconv.py's kernel
    or raises: its wrapper takes no CPU tensor, and the routed op sends
    every non-CPU tensor to the kernel (a half tensor is refused there,
    not computed by the plain version)."""
    from ssgvc_tpu_torch.layers import blocks
    from ssgvc_tpu_torch.ops import qconv as Q

    monkeypatch.setenv("SSGVC_INT8", "1")
    if torch.cuda.is_available():
        conv = blocks.Conv(8, 8, 3, padding=1)
        assert conv.weight.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            blocks.Conv(8, 8, 3, padding=1)
    wq, s_w = Q.quantize_weight(torch.ones((4, 2, 1, 1)))

    class Half:                     # a CUDA half tensor, as the op sees it
        device = torch.device("cuda")
        dtype = torch.float16

        def contiguous(self):
            return self

    with pytest.raises(TypeError):
        Q.qconv(Half(), wq, s_w, torch.zeros(4), torch.ones(()), 1, 1,
                (0, 0, 0, 0))
    with pytest.raises(ValueError, match="CUDA"):
        Q.qconv_cuda(torch.ones((1, 2, 2, 2)), wq, s_w, torch.zeros(4),
                     torch.ones(()), 1, 1, (0, 0, 0, 0), torch.float32)
    src = (ROOT / "ssgvc_tpu_torch" / "ops" / "qconv.py").read_text()
    assert "except" not in src


#: each RD entry point with the least arguments that reach a model
RD_MAINS = {"rd_tpu": ["--profile", "tiny", "--eval-clips", "2"],
            "rd_full": ["--profile", "tiny"], "rd_demo": ["1"],
            "rd_eval": ["--profile", "tiny", "--crops", "64"],
            "rd_continue": ["1", "--profile", "tiny", "--recon-skip"],
            "mask_train_phase": ["1", "--profile", "tiny"],
            "mask_prop_value": ["--profile", "tiny", "--crop", "64"],
            "e2e_waymo_format": [], "diag_pframe": ["--res", "64"],
            "probes.probe_latent_liveness": ["1"],
            "probes.probe_dist_only": ["plain", "1"]}
#: the entry points that load a checkpoint of the profile before a model
#: (the mask experiments' under their default "-roisub" tag)
RD_LOADERS = {"rd_eval": "", "rd_continue": "", "mask_train_phase": "-roisub",
              "mask_prop_value": "-roisub"}


@pytest.mark.parametrize("name", sorted(RD_MAINS))
def test_rd_harness_mains_default_to_the_card(name, tmp_path, monkeypatch):
    """Without --device=cpu every RD entry point and diagnostic builds its
    models on the card: a host with no card raises there (rd_eval and
    rd_continue once a checkpoint of the profile exists to load, as the
    mask experiments do; the diagnostics build their models before they
    read a checkpoint)."""
    import importlib

    from ssgvc_tpu_torch.experiments import rd_full

    mod = importlib.import_module(f"ssgvc_tpu_torch.experiments.{name}")
    for attr in ("MID_DMC", "MID_DMCI", "PROFILE", "RECON_SKIP",
                 "CKPT_EXTRA", "LNORM", "DEVICE"):
        monkeypatch.setattr(rd_full, attr, getattr(rd_full, attr))
    monkeypatch.chdir(tmp_path)
    if name in RD_LOADERS:
        rd_full.set_profile("tiny")
        rd_full.RECON_SKIP = True
        rd_full.CKPT_EXTRA = RD_LOADERS[name]
        os.makedirs(os.path.dirname(rd_full.ckpt_path("plain")))
        for v in ("performance", "fast", "mask_prop"):
            torch.save({"params_p": {}, "params_i": {}}, rd_full.ckpt_path(v))
    assert rd_full.split_device(RD_MAINS[name]) == ("cuda", RD_MAINS[name])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(list(RD_MAINS[name]))


#: each measuring script with device work, with the least arguments that
#: reach a model or a tensor on the device
MEASURE_MAINS = {"profile_stages": [], "bench_sweep": ["1"],
                 "trace_bench": [], "bench_coded": ["2"],
                 "smoke_128px": ["--k", "1"], "probe_int8": ["--chain", "1"]}


@pytest.mark.parametrize("name", sorted(MEASURE_MAINS))
def test_measure_scripts_default_to_the_card(name, tmp_path, monkeypatch):
    """Without --device=cpu every measuring script with device work puts
    its model or its operands on the card: a host with no card raises
    there, before any file is written."""
    import importlib

    from ssgvc_tpu_torch.experiments import rd_full

    mod = importlib.import_module(f"ssgvc_tpu_torch.experiments.{name}")
    monkeypatch.setattr(rd_full, "DEVICE", rd_full.DEVICE)
    monkeypatch.chdir(tmp_path)
    assert rd_full.split_device(MEASURE_MAINS[name]) == (
        "cuda", MEASURE_MAINS[name])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(list(MEASURE_MAINS[name]))
    assert list(tmp_path.iterdir()) == []


def test_bench_worker_defaults_to_the_card(tmp_path, monkeypatch):
    """The bench's worker (``python3 -m ssgvc_tpu_torch.bench``'s
    measurement) wants the card: a host with no card raises at its device
    probe, before any kernel build or file, its breadcrumbs saying so."""
    from ssgvc_tpu_torch import bench

    if torch.cuda.is_available():
        pytest.skip("a card is present: the worker would measure on it")
    status = tmp_path / "status"
    monkeypatch.setenv(bench.STATUS_ENV, str(status))
    monkeypatch.delenv("SSGVC_INT8", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.worker()
    crumbs = [ln.split(" ", 1)[1] for ln in status.read_text().splitlines()]
    assert crumbs == ["init: importing torch", "init: device probe"]
    assert list(tmp_path.iterdir()) == [status]
