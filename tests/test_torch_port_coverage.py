"""The port does all that the JAX package does, held by reading source
(AST only, no import): every module of ``ssgvc_tpu/`` and every JAX-side
script that was in the tree before the port began has its counterpart
under ``ssgvc_tpu_torch/``, or stands in :data:`NOT_TO_PORT` with its
reason; every public top-level name of a JAX module (a ``def``, ``class``
or assignment not starting with ``_``) is defined by the same name at the
top of its counterpart, or stands in :data:`RENAMED` with its target or
its reason.

The lists are frozen: the JAX package and its scripts do not change, and
a test holds the frozen module list to the package as it stands.
"""

import ast
from pathlib import Path

import pytest
from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "ssgvc_tpu"
PORT = ROOT / "ssgvc_tpu_torch"

#: every module of ssgvc_tpu/, relative to it
JAX_MODULES = [
    "__init__.py", "coding/__init__.py", "coding/bitstream.py",
    "coding/cdf.py", "coding/codec.py", "coding/rans.py", "coding/session.py",
    "config.py", "data/__init__.py", "data/build_cache.py", "data/dataset.py",
    "data/device_synth.py", "data/lidar.py", "data/tfrecord.py",
    "data/video_transform.py", "data/vimeo.py", "data/waymo_proto.py",
    "layers/__init__.py", "layers/blocks.py", "layers/quant.py",
    "models/__init__.py", "models/common.py", "models/dmc.py",
    "models/dmci.py", "models/entropy.py", "models/inference_api.py",
    "ops/__init__.py", "ops/pallas_dcb.py", "ops/pallas_dcb_chain.py",
    "ops/pixel.py", "parallel/__init__.py", "parallel/mesh.py",
    "parallel/spatial.py", "training/__init__.py", "training/calibrate.py",
    "training/evaluate.py", "training/loss.py", "training/optimizers.py",
    "training/schedule.py", "training/trainer.py", "utils/__init__.py",
    "utils/checkpoint.py", "utils/debug.py", "utils/logging.py",
    "utils/metrics.py", "utils/profiling.py", "utils/torch_import.py",
    "utils/transforms.py", "utils/video_io.py", "utils/visualize.py"]

#: the JAX-side scripts in the tree before the port began (``git ls-tree``
#: of the commit before the port's first), relative to the repo root
JAX_SCRIPTS = [
    "__graft_entry__.py", "bench.py", "experiments/bench_coded.py",
    "experiments/bench_flags.py", "experiments/bench_rans.py",
    "experiments/bench_sweep.py", "experiments/convert_trace.py",
    "experiments/diag_pframe.py", "experiments/e2e_waymo_format.py",
    "experiments/mask_prop_value.py", "experiments/mask_train_phase.py",
    "experiments/pallas_chain_hw.py", "experiments/pallas_dcb_hw.py",
    "experiments/probe_int8.py", "experiments/probes/probe_dist_only.py",
    "experiments/probes/probe_latent_liveness.py",
    "experiments/profile_stages.py", "experiments/rd_continue.py",
    "experiments/rd_demo.py", "experiments/rd_eval.py",
    "experiments/rd_full.py", "experiments/rd_keep_best.py",
    "experiments/rd_report.py", "experiments/rd_tpu.py",
    "experiments/rd_trajectory.py", "experiments/smoke_128px.py",
    "experiments/trace_bench.py", "experiments/xplane_stats.py",
    "scripts/decode.py", "scripts/encode.py",
    "scripts/post_marathon_bench_r04.sh", "scripts/post_marathon_bench_r05.sh",
    "scripts/post_marathon_eval_r04.sh", "scripts/post_marathon_eval_r05.sh",
    "scripts/rd_continuation_r04.sh", "scripts/rd_fresh_marathon.sh",
    "scripts/rd_harvest.sh", "scripts/rd_marathon.sh",
    "scripts/rd_marathon_r05.sh", "scripts/rd_polish_192_r04.sh",
    "scripts/rd_watch_harvest_r04b.sh", "scripts/rd_watch_harvest_r04c.sh",
    "scripts/tpu_oneshot.sh", "scripts/tpu_probe.sh",
    "trainer_image_model.py", "trainer_seg_video_model.py"]

#: counterparts under another name (else the same path under the port)
MOVED = {"ops/pallas_dcb.py": "ops/dcb.py",
         "ops/pallas_dcb_chain.py": "ops/dcb_chain.py",
         "__graft_entry__.py": "graft_entry.py"}

_TPU_TOOL = ("a tool of the TPU stack; utils/profiling.trace and "
             "chip_smoke.py's build phase stand in for it on the card")
_MARATHON = "a shell marathon that runs the JAX scripts on the TPU"
#: scripts with no counterpart, and why
NOT_TO_PORT = {
    "experiments/pallas_dcb_hw.py": "times the Pallas DCB under Mosaic on "
                                    "the TPU; " + _TPU_TOOL,
    "experiments/pallas_chain_hw.py": "times the Pallas chain under Mosaic "
                                      "on the TPU; " + _TPU_TOOL,
    "experiments/xplane_stats.py": "reads XLA xplane traces; " + _TPU_TOOL,
    "experiments/convert_trace.py": "converts XLA traces; " + _TPU_TOOL,
    "experiments/bench_flags.py": "sweeps XLA flags; " + _TPU_TOOL,
    **{s: _MARATHON for s in JAX_SCRIPTS if s.endswith(".sh")}}

#: "module:name" -> (port module, port name) where the name moved or was
#: renamed, or (None, reason) where it is a JAX-only concept
RENAMED = {
    "coding/cdf.py:scale_index_params": ("models/entropy.py",
                                         "scale_index_params"),
    "layers/blocks.py:wsilu": ("ops/dcb.py", "wsilu"),
    "layers/blocks.py:conv": ("layers/blocks.py", "Conv"),
    "layers/blocks.py:QuantConv": ("layers/blocks.py", "Conv"),
    "layers/blocks.py:Dtype": (None, "flax's dtype annotation (Any); the "
                                     "port's modules take a torch.dtype"),
    "ops/pallas_dcb.py:dcb_fused": ("ops/dcb.py", "dcb"),
    "ops/pallas_dcb_chain.py:dcb_chain_fused": ("ops/dcb_chain.py",
                                                "dcb_chain"),
    "parallel/mesh.py:batch_sharding": ("parallel/mesh.py", "shard_batch"),
    "parallel/mesh.py:replicated": ("parallel/mesh.py", "replicate"),
    "parallel/spatial.py:jit_spatial_pframe": ("parallel/spatial.py",
                                               "spatial_pframe"),
    "utils/torch_import.py:torch_key_to_flax_path": (
        "utils/torch_import.py", "torch_key_to_port_key"),
    "utils/torch_import.py:align_params": ("utils/torch_import.py",
                                           "align_state_dict"),
    "utils/torch_import.py:FlatParams": (None, "flax's flat path -> array "
                                               "dict; a state_dict is that "
                                               "already"),
    "utils/torch_import.py:flatten": (None, "flattens a flax param tree; a "
                                            "state_dict is flat"),
    "utils/torch_import.py:unflatten": (None, "builds a flax param tree; a "
                                              "state_dict is flat"),
}


def defined_names(path: Path) -> set:
    """Public names a module defines at its top level: ``def``, ``class``
    and assignment targets (imports do not count)."""
    out = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(n.id for t in node.targets for n in ast.walk(t)
                       if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                             ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def test_frozen_lists_are_the_jax_trees():
    """The frozen module list is the JAX package as it stands; every
    frozen script is still in the tree, and the maps name only listed
    files."""
    assert sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py")) \
        == sorted(JAX_MODULES)
    assert [s for s in JAX_SCRIPTS if not (ROOT / s).is_file()] == []
    assert set(NOT_TO_PORT) <= set(JAX_SCRIPTS)
    assert set(MOVED) <= set(JAX_MODULES) | set(JAX_SCRIPTS)
    assert {k.split(":")[0] for k in RENAMED} <= set(JAX_MODULES)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_jax_module_has_its_counterpart(module):
    """The module's counterpart exists, and each public name of the JAX
    module is defined there or stands in RENAMED."""
    port = PORT / MOVED.get(module, module)
    assert port.is_file(), f"no counterpart of ssgvc_tpu/{module}"
    have = defined_names(port)
    missing = sorted(n for n in defined_names(JAX / module)
                     if n not in have and f"{module}:{n}" not in RENAMED)
    assert not missing, f"ssgvc_tpu/{module}: {missing}"


@pytest.mark.parametrize("key", sorted(RENAMED))
def test_renamed_names_have_their_target_or_reason(key):
    """A renamed name is really absent by its own name, and its target is
    defined in the port module named; a JAX-only name gives its reason."""
    module, name = key.split(":")
    assert name in defined_names(JAX / module)
    assert name not in defined_names(PORT / MOVED.get(module, module))
    target, what = RENAMED[key]
    if target is None:
        assert len(what) > 20
    else:
        assert what in defined_names(PORT / target), key


@pytest.mark.parametrize("script", JAX_SCRIPTS)
def test_jax_script_has_its_counterpart(script):
    """Each JAX-side script has its counterpart under the port, or its
    reason not to be ported (and then none)."""
    port = PORT / MOVED.get(script, script)
    if script in NOT_TO_PORT:
        assert NOT_TO_PORT[script] and not port.exists()
        return
    assert port.is_file(), f"no counterpart of {script}"
    tree = ast.parse(port.read_text())
    entry = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert entry & {"main", "entry", "worker"}, f"{port}: no entry point"
