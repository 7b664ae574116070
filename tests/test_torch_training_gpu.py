"""Training on the card (marked ``gpu``; skipped where no CUDA device is
present): the DepthConvBlock backward kernels (csrc/dcb_bwd.cu) against
their plain versions at every shape a training micro-step gives them, both
forward kernels at B = 4 against four B = 1 launches bit for bit, and the
card's bf16 gop_loss and gradient against the CPU port's fp32 and bf16 at
full width.

This file imports neither JAX nor the JAX package:
``python -m pytest tests/test_torch_training_gpu.py -m gpu -q --noconftest``.

Tolerances: a backward kernel's fp32 outputs within 1e-4 of the plain
version's norm (the same fp32 math, other orders and ``__expf``), its bf16
outputs within 1e-2 (one rounding flip is 2^-8 relative); the training
cross-check at loss rel 5e-2, the card's bf16 gradient at cosine >=
``chip_smoke.XTRAIN_COSINE`` to the CPU's fp32 one and >=
``chip_smoke.XTRAIN_KERNEL_COSINE`` to the CPU's bf16 one (the same rounding
points: what is left is the card's kernels).
"""

import numpy as np
import pytest
import torch

import chip_smoke


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,c,with_q",
                         [s[:4] for s in chip_smoke.BWD_SHAPES]
                         + [(7, 9, 64, True), (3, 5, 368, False)])
def test_backward_kernels_match_plain(h, w, c, with_q):
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    dev = _card()
    rng = np.random.default_rng(h * w + c)
    before = dict(dg.launches)
    errs = chip_smoke.check_backward_kernels(
        torch, chip_smoke.bwd_case(torch, rng, 4, h, w, c, with_q, dev))
    assert set(errs) == set(dg.launches)
    assert all(dg.launches[k] > before[k] for k in dg.launches)


@pytest.mark.gpu
def test_backward_kernels_are_deterministic():
    """No atomics: the same inputs give the same bits."""
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    dev = _card()
    case = chip_smoke.bwd_case(torch, np.random.default_rng(5), 4, 16, 16,
                               256, True, dev)
    runs = []
    for _ in range(2):
        part = torch.zeros(dg.partial_rows(case["a0"]),
                           (dg.GATE_COLS + dg.DW_COLS) * 256, device=dev)
        dp, _, _ = dg.gate_bwd_cuda(case["df"], case["p"], case["dy"],
                                    case["q"], case["resid"], part, 0)
        g = dg.dw_fwd_cuda(case["a0"], case["taps"], case["b2"],
                           torch.bfloat16)
        da0 = dg.dw_bwd_cuda(case["dg"], case["a0"], case["taps"],
                             case["du"], part, dg.GATE_COLS * 256)
        runs.append((dp, g, da0, dg.grad_reduce_cuda(part)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_batched_forward_kernels_equal_one_image_at_a_time():
    _card()
    rows = chip_smoke.phase_batch(torch, 0, "card")
    assert len(rows["dcb"]) == len(chip_smoke.TRAIN_SINGLE)
    assert len(rows["dcb_chain"]) == len(chip_smoke.TRAIN_CHAIN)


@pytest.mark.gpu
def test_block_gradient_on_the_card_matches_the_cpu():
    """DCBFunction through the kernels (bf16 forward, kernel backward)
    against the same Function on the CPU, where it runs the plain
    versions, on the same bf16 inputs."""
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    dev = _card()
    rng = np.random.default_rng(3)
    c = 256
    x = torch.tensor(rng.standard_normal((4, 16, 16, c)),
                     dtype=torch.bfloat16)
    q = torch.linspace(0.5, 1.5, c).to(torch.bfloat16)
    params = chip_smoke.block_params(torch, c, rng, "cpu")
    cot = torch.tensor(rng.standard_normal((4, 16, 16, c)),
                       dtype=torch.float32)
    grads = {}
    for d in ("cpu", dev):
        leaf = lambda t: t.detach().clone().to(d).requires_grad_(True)
        xs, qs = leaf(x), leaf(q)
        ps = [leaf(p) for p in params]
        y = dg.dcb_grad(xs, ps, qs, True)
        (y.float() * cot.to(d)).sum().backward()
        grads[str(d)] = [t.grad.float().cpu() for t in [xs, qs] + ps]
    for a, b in zip(grads["cpu"], grads[str(dev)]):
        rel = float(torch.linalg.vector_norm(a - b)
                    / torch.linalg.vector_norm(a))
        assert rel <= 2e-2


@pytest.mark.gpu
def test_training_on_the_card_matches_the_cpu_port():
    _card()
    r = chip_smoke.train_cross_check(torch, 0)
    assert r["card_vs_cpu32"]["loss_rel"] <= 5e-2
    assert r["card_vs_cpu32"]["grad_cosine"] >= chip_smoke.XTRAIN_COSINE
    assert (r["card_vs_cpu16"]["grad_cosine"]
            >= chip_smoke.XTRAIN_KERNEL_COSINE)
