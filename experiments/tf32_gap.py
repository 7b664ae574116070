"""What cuDNN's TF32 would do to the port's fp32 path on the card.

With ``torch.backends.cudnn.allow_tf32`` left at its default (True), the
port runs an fp32 model's cuDNN convs without TF32 (``layers.blocks.
cudnn_fp32``, in each conv's forward and in ``Trainer.backward``). This
prints, for an fp32 strided conv and the tiny-profile fp32 Trainer's
gop_loss gradient (the helpers of ``tests/test_torch_training_gpu.py``),
the gap between the card and the CPU in three settings: TF32 off for the
process; the flag left on (the port as it is); the flag left on with
``cudnn_fp32`` replaced by a no-op. Then the DMC parameters with the
largest relative gradient gaps.

    python experiments/tf32_gap.py        (needs a CUDA device)
"""

import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import torch  # noqa: E402

import test_torch_training_gpu as t  # noqa: E402
from ssgvc_tpu_torch.layers import blocks  # noqa: E402
from ssgvc_tpu_torch.training import trainer  # noqa: E402


def param_gaps(g, ref, model):
    """(relative gap, reference norm, name) of each parameter, worst
    first."""
    rows, off = [], 0
    for name, p in model.named_parameters():
        n = p.numel()
        a, b = g[off:off + n], ref[off:off + n]
        off += n
        norm = float(torch.linalg.vector_norm(b))
        rows.append((float(torch.linalg.vector_norm(a - b)) / max(norm, 1e-30),
                     norm, name))
    return sorted(rows, reverse=True)


def main():
    if not torch.cuda.is_available():
        print("tf32_gap: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    l_cpu, g_cpu, states = t.trainer_grads("cpu")
    from ssgvc_tpu_torch.config import TrainConfig
    from ssgvc_tpu_torch.training.trainer import Trainer
    shapes = Trainer(TrainConfig(precision="fp32", model_profile="tiny",
                                 recon_residual=True), device="cpu").dmc
    print(torch.cuda.get_device_name(0))
    for label, flag in (("TF32 off", False), ("flag on, the port", True),
                        ("flag on, cudnn_fp32 a no-op", True)):
        if "no-op" in label:
            null = lambda *a, **k: contextlib.nullcontext()  # noqa: E731
            blocks.cudnn_fp32 = trainer.cudnn_fp32 = null
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        allow_tf32=flag):
            conv = t.conv_gap(dev)
            loss, grad, _ = t.trainer_grads(dev, states)
        rows = param_gaps(grad, g_cpu, shapes)
        print(f"{label}: conv output max rel {conv[0]:.3e}, input gradient "
              f"{conv[1]:.3e}, weight gradient {conv[2]:.3e}; Trainer loss "
              f"rel {abs(loss - l_cpu) / abs(l_cpu):.3e}, DMC gradient rel "
              f"{t.grad_rel(grad, g_cpu):.3e}, "
              f"{sum(r > 1e-5 for r, _, _ in rows)} of {len(rows)} "
              "parameters over 1e-5; worst (rel, norm): "
              + ", ".join(f"{k} {r:.2e} {n:.2e}" for r, n, k in rows[:4]),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
