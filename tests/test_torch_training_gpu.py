"""Training on the card (marked ``gpu``; skipped where no CUDA device is
present): the DepthConvBlock backward kernels (csrc/dcb_bwd.cu) against
their plain versions at every shape a training micro-step and an image
trainer's step give them (dw_fwd also at the RD recipe's shapes and on
edge tiles, image by image and rerun bit for bit), both
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
points: what is left is the card's kernels). The fp32 block and chain
gradients (the fp32 forward kernel, the backward kernels with fp32
activations) against the CPU's within 1e-4 relative: the same fp32 math,
summed in other orders. With cuDNN's TF32 flag left at its default
(True), an fp32 model's strided conv and the Trainer's fp32 backward on the
card: the conv against the CPU within 1e-5 of the output's largest value
(and its gradients of their norm); the tiny Trainer's whole DMC gradient
within 1e-5 of the card's own with the flag off, and within 5e-4 of the
CPU's (with TF32 off everywhere the card and the CPU differ by 1.6e-4 at
this seed: fp32 sums in other orders through a GOP, largest on parameters
of small gradient). With TF32 the conv misses by ~3e-4 and the gradient by
~8e-4 (``experiments/tf32_gap.py``).
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
@pytest.mark.parametrize("act", ["bfloat16", "float32"])
@pytest.mark.parametrize("h,w,c,with_q",
                         [s[:4] for s in chip_smoke.BWD_SHAPES]
                         + [(7, 9, 64, True), (3, 5, 368, False),
                            (5, 7, 32, True), (1, 1, 96, False),
                            (2, 2, 32, False), (12, 20, 96, True),
                            (16, 16, 96, False)])
def test_backward_kernels_match_plain(h, w, c, with_q, act):
    """Each kernel's outputs, and each partials row against its tile's
    plain sums (chip_smoke.check_backward_kernels), at the training shapes,
    ragged and one-tile frames and the RD recipe's widths, with the block's
    activations in bf16 and in fp32."""
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    dev = _card()
    rng = np.random.default_rng(h * w + c)
    before = dict(dg.launches)
    errs = chip_smoke.check_backward_kernels(
        torch, chip_smoke.bwd_case(torch, rng, 4, h, w, c, with_q, dev,
                                   getattr(torch, act)))
    assert set(errs) == set(dg.launches)
    assert all(dg.launches[k] > before[k] for k in dg.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["bfloat16", "float32"])
@pytest.mark.parametrize("h,w,c,with_q",
                         [s[:4] for s in chip_smoke.IMAGE_BWD_SHAPES])
def test_backward_kernels_match_plain_at_the_image_step(h, w, c, with_q,
                                                        act):
    """The same at every shape the image trainer's step gives the backward
    kernels: the DMCI at full width, B = 16 crops of 256x256 (C = 368, a
    partial 32-channel stripe; 512; 192)."""
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    dev = _card()
    rng = np.random.default_rng(h * w + c + with_q)
    before = dict(dg.launches)
    errs = chip_smoke.check_backward_kernels(
        torch, chip_smoke.bwd_case(torch, rng, chip_smoke.IMAGE_B, h, w, c,
                                   with_q, dev, getattr(torch, act)))
    assert set(errs) == set(dg.launches)
    assert all(dg.launches[k] > before[k] for k in dg.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["bfloat16", "float32"])
def test_backward_kernels_are_deterministic(act):
    """No atomics: the same inputs give the same bits, outputs and partials
    alike."""
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    dev = _card()
    dt = getattr(torch, act)
    case = chip_smoke.bwd_case(torch, np.random.default_rng(5), 4, 16, 16,
                               256, True, dev, dt)
    runs = []
    for _ in range(2):
        part = torch.zeros(dg.partial_rows(case["a0"]),
                           (dg.GATE_COLS + dg.DW_COLS) * 256, device=dev)
        dp, fr, dyq = dg.gate_bwd_cuda(case["df"], case["p"], case["dy"],
                                       case["q"], case["resid"], part, 0)
        g = dg.dw_fwd_cuda(case["a0"], case["taps"], case["b2"], dt)
        da0 = dg.dw_bwd_cuda(case["dg"], case["a0"], case["taps"],
                             case["du"], part, dg.GATE_COLS * 256)
        runs.append((dp, fr, dyq, g, da0, part, dg.grad_reduce_cuda(part)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    # the new partition: one partials row per 8x8 tile, 16 at 4x16x16
    assert part.shape[0] == 16
    # grad_reduce is grad_reduce_order's additions, in its order, on the
    # partials the kernels wrote, and also past one chunk of rows (a
    # second pass)
    assert torch.equal(runs[0][-1].cpu(), dg.grad_reduce_order(part.cpu()))
    rng = np.random.default_rng(6)
    for rows in (1, 7, 128, dg.RED_CHUNK + 3):
        part = torch.tensor(rng.standard_normal((rows, 18 * 40)),
                            dtype=torch.float32, device=dev)
        assert torch.equal(dg.grad_reduce_cuda(part).cpu(),
                           dg.grad_reduce_order(part.cpu())), rows


@pytest.mark.gpu
def test_backward_kernels_refuse_what_they_do_not_take():
    """dw_fwd, gate_bwd and dw_bwd take C a multiple of 8 and 16-byte
    aligned operands; anything else raises (there is no other route)."""
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    dev = _card()
    k = chip_smoke.bwd_case(torch, np.random.default_rng(7), 2, 4, 4, 12,
                            True, dev)
    part = torch.zeros(2, 18 * 12, device=dev)
    before = dict(dg.launches)
    with pytest.raises(ValueError, match="multiple of 8"):
        dg.gate_bwd_cuda(k["df"], k["p"], k["dy"], k["q"], k["resid"],
                         part, 0)
    with pytest.raises(ValueError, match="multiple of 8"):
        dg.dw_bwd_cuda(k["dg"], k["a0"], k["taps"], k["du"], part, 72)
    for act in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="multiple of 8"):
            dg.dw_fwd_cuda(k["a0"], k["taps"], k["b2"], act)
    k = chip_smoke.bwd_case(torch, np.random.default_rng(7), 2, 4, 4, 8,
                            False, dev)
    off = torch.zeros(2 * 4 * 4 * 8 + 1, device=dev)[1:].reshape(2, 4, 4, 8)
    off.copy_(k["dg"])
    with pytest.raises(ValueError, match="aligned"):
        dg.dw_bwd_cuda(off, k["a0"], k["taps"], k["du"],
                       torch.zeros(2, 18 * 8, device=dev), 48)
    off.copy_(k["a0"])
    b2_off = torch.zeros(8 + 1, device=dev)[1:]
    b2_off.copy_(k["b2"])
    for act in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="aligned"):
            dg.dw_fwd_cuda(off, k["taps"], k["b2"], act)
        with pytest.raises(ValueError, match="aligned"):
            dg.dw_fwd_cuda(k["a0"], k["taps"], b2_off, act)
    assert dg.launches == before          # nothing launched
    # the aligned operands themselves run
    dg.dw_fwd_cuda(k["a0"], k["taps"], k["b2"], torch.float32)
    assert dg.launches["dw_fwd"] == before["dw_fwd"] + 1


#: dw_fwd beyond the training shapes (B = 4): the RD recipe's (B = 8, rd-mid
#: widths 32-96 at 8x8 and below), edge tiles (H, W not multiples of the
#: 8x8 tile, partial channel slices) and a one-tile, one-slice frame
DW_FWD_SHAPES = list(dict.fromkeys(
    [(chip_smoke.TRAIN_B, h, w, c) for h, w, c, _, _ in chip_smoke.BWD_SHAPES]
    + [(8, 8, 8, 96), (8, 8, 8, 64), (8, 4, 4, 64), (8, 4, 4, 32),
       (8, 2, 2, 32), (8, 1, 1, 32)]
    + [(4, 12, 20, 24), (3, 9, 5, 8), (2, 17, 9, 40), (1, 8, 8, 32)]))


def _dw_fwd_inputs(shape, seed, dev):
    rng = np.random.default_rng(seed)
    t = lambda *s, std=1.0: torch.tensor(rng.standard_normal(s) * std,
                                         dtype=torch.float32, device=dev)
    c = shape[-1]
    return t(*shape), t(9, c, std=1 / 3), t(c, std=0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", DW_FWD_SHAPES)
def test_dw_fwd_matches_plain(shape, act):
    """dw_fwd_cuda's g against dw_fwd_plain on the same inputs: bf16 within
    chip_smoke.REL_TOL (one rounding flip is 2^-8 relative), fp32 within
    chip_smoke.BWD_FP32_TOL (the same fp32 math, __expf and another
    order), relative Frobenius error."""
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    dev = _card()
    dt = getattr(torch, act)
    a0, taps, b2 = _dw_fwd_inputs(shape, sum(shape), dev)
    before = dg.launches["dw_fwd"]
    g = dg.dw_fwd_cuda(a0, taps, b2, dt)
    assert dg.launches["dw_fwd"] == before + 1
    assert g.dtype == dt and tuple(g.shape) == shape
    chip_smoke.check_close(torch, f"dw_fwd {shape} {act}", g,
                           dg.dw_fwd_plain(a0, taps, b2, dt),
                           chip_smoke.REL_TOL if act == "bfloat16"
                           else chip_smoke.BWD_FP32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(3, 9, 13, 40), (4, 16, 16, 32),
                                   (8, 2, 2, 32)])
def test_dw_fwd_keeps_each_image_to_itself(shape, act):
    """With B > 1 the halo stays inside each image: the B-image launch
    equals B one-image launches bit for bit, and another image 1 leaves
    every other image's g as it was."""
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    dev = _card()
    dt = getattr(torch, act)
    a0, taps, b2 = _dw_fwd_inputs(shape, 3, dev)
    g = dg.dw_fwd_cuda(a0, taps, b2, dt)
    for i in range(shape[0]):
        assert torch.equal(g[i:i + 1], dg.dw_fwd_cuda(
            a0[i:i + 1].contiguous(), taps, b2, dt)), i
    a1 = a0.clone()
    a1[1] = 10.0 * torch.rand_like(a1[1]) - 5.0
    g1 = dg.dw_fwd_cuda(a1, taps, b2, dt)
    keep = [i for i in range(shape[0]) if i != 1]
    assert torch.equal(g1[keep], g[keep])
    assert not torch.equal(g1[1], g[1])


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(4, 16, 16, 320), (8, 8, 8, 64),
                                   (3, 9, 5, 8)])
def test_dw_fwd_reruns_are_bit_equal(shape, act):
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    dev = _card()
    dt = getattr(torch, act)
    a0, taps, b2 = _dw_fwd_inputs(shape, 9, dev)
    g = dg.dw_fwd_cuda(a0, taps, b2, dt)
    for _ in range(3):
        assert torch.equal(dg.dw_fwd_cuda(a0, taps, b2, dt), g)


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
@pytest.mark.parametrize("kernel,c", [("dcb", 32), ("dcb", 96),
                                      ("dcb_chain", 64)])
def test_fp32_block_gradient_on_the_card_matches_the_cpu(kernel, c):
    """DCBFunction / DCBChainFunction in fp32 on the card (csrc/dcb_f32.cu
    forward, csrc/dcb_bwd.cu with fp32 activations) against the same
    Functions on the CPU, on the same fp32 inputs."""
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    dev = _card()
    rng = np.random.default_rng(c)
    x = torch.tensor(rng.standard_normal((4, 8, 8, c)), dtype=torch.float32)
    q = torch.linspace(0.5, 1.5, c)
    n = 1 if kernel == "dcb" else 3
    blocks = [chip_smoke.block_params(torch, c, rng, "cpu") for _ in range(n)]
    cot = torch.tensor(rng.standard_normal((4, 8, 8, c)),
                       dtype=torch.float32)
    grads = {}
    for d in ("cpu", dev):
        leaf = lambda t: t.detach().clone().to(d).requires_grad_(True)
        xs, qs = leaf(x), leaf(q)
        ps = [[leaf(p) for p in blk] for blk in blocks]
        y = (dg.dcb_grad(xs, ps[0], qs, True) if kernel == "dcb"
             else dg.dcb_chain_grad(xs, ps, qs))
        assert y.dtype == torch.float32
        (y * cot.to(d)).sum().backward()
        grads[str(d)] = [t.grad.cpu() for t in [xs, qs] + sum(ps, [])]
    for a, b in zip(grads["cpu"], grads[str(dev)]):
        rel = float(torch.linalg.vector_norm(a - b)
                    / torch.linalg.vector_norm(a))
        assert rel <= 1e-4


@pytest.mark.gpu
def test_training_on_the_card_matches_the_cpu_port():
    _card()
    r = chip_smoke.train_cross_check(torch, 0)
    assert r["card_vs_cpu32"]["loss_rel"] <= 5e-2
    assert r["card_vs_cpu32"]["grad_cosine"] >= chip_smoke.XTRAIN_COSINE
    assert (r["card_vs_cpu16"]["grad_cosine"]
            >= chip_smoke.XTRAIN_KERNEL_COSINE)


def _card_tf32():
    """The card, with torch's own default for matmuls (no TF32); each test
    sets cuDNN's TF32 flag inside ``torch.backends.cudnn.flags``, which
    restores it afterwards: the port's fp32 path must not rely on a caller
    having turned it off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def grad_rel(a, ref):
    return float(torch.linalg.vector_norm(a - ref)
                 / torch.linalg.vector_norm(ref))


def conv_gap(dev):
    """An fp32 Conv 3x3 stride 2 (64 -> 96, as the models' strided convs)
    on ``dev`` against the CPU on the same weights: (output's max |d| / max
    |ref|, input gradient's and weight gradient's relative norms). The
    backward runs under ``cudnn_fp32`` as ``Trainer.backward`` runs it."""
    from ssgvc_tpu_torch.layers.blocks import Conv, cudnn_fp32

    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((2, 32, 32, 64)),
                     dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((96, 64, 3, 3)) / 24.0,
                     dtype=torch.float32)
    bias = torch.tensor(rng.standard_normal(96) * 0.1, dtype=torch.float32)
    cot = torch.tensor(rng.standard_normal((2, 16, 16, 96)),
                       dtype=torch.float32)
    out = {}
    for d in ("cpu", dev):
        conv = Conv(64, 96, 3, stride=2, padding=1, device=d)
        conv.load_state_dict({"weight": w, "bias": bias})
        xs = x.to(d).detach().requires_grad_(True)
        y = conv(xs)
        with cudnn_fp32(torch.float32, torch.device(d)):
            (y * cot.to(d)).sum().backward()
        out[str(d)] = (y.detach().cpu(), xs.grad.cpu(),
                       conv.weight.grad.cpu())
    (y0, gx0, gw0), (y1, gx1, gw1) = out["cpu"], out[str(dev)]
    return (float((y1 - y0).abs().max() / y0.abs().max()),
            grad_rel(gx1, gx0), grad_rel(gw1, gw0))


def trainer_grads(dev, states=None):
    """The fp32 Trainer at the tiny profile on ``dev``: gop_loss
    (train=False: STE rounding, no noise) and ``Trainer.backward`` on one
    64x64 clip of T=3, weights from ``random_weights`` (or ``states``, the
    (DMC, DMCI) state dicts of an earlier call). Returns (loss, the DMC's
    gradient flat on the CPU, states)."""
    from ssgvc_tpu_torch.config import TrainConfig
    from ssgvc_tpu_torch.data.device_synth import synth_batch
    from ssgvc_tpu_torch.training.trainer import Trainer

    data = synth_batch(torch.Generator().manual_seed(4), batch=1, size=64,
                       seq_len=3, device="cpu")
    tr = Trainer(TrainConfig(precision="fp32", model_profile="tiny",
                             recon_residual=True), device=dev)
    assert tr.dmc.dtype == torch.float32
    if states is None:
        chip_smoke.random_weights(torch, tr.dmc, 0, chip_smoke.TRAIN_HEADS)
        chip_smoke.random_weights(torch, tr.dmci, 0, chip_smoke.DMCI_HEADS)
        states = (tr.dmc.state_dict(), tr.dmci.state_dict())
    else:
        tr.dmc.load_state_dict(states[0], strict=True)
        tr.dmci.load_state_dict(states[1], strict=True)
    loss, _ = tr.gop_loss(data["frames"].to(dev), data["masks"].to(dev),
                          chip_smoke.QP, torch.Generator().manual_seed(0),
                          train=False, eval_mode=False)
    tr.backward(loss)
    grad = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                      .reshape(-1).cpu() for p in tr.dmc.parameters()])
    return float(loss.detach()), grad, states


@pytest.mark.gpu
def test_fp32_strided_conv_on_the_card_is_fp32_with_tf32_allowed():
    dev = _card_tf32()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        y, gx, gw = conv_gap(dev)
        assert torch.backends.cudnn.allow_tf32       # restored by the port
    assert y <= 1e-5 and gx <= 1e-5 and gw <= 1e-5


@pytest.mark.gpu
def test_fp32_trainer_backward_on_the_card_is_fp32_with_tf32_allowed():
    """The card's gradient with the flag left on against the card's with
    it off (deterministic cuDNN for both: the same algorithms, so only
    TF32 could move it) within 1e-5, and against the CPU's within 5e-4."""
    dev = _card_tf32()
    l_cpu, g_cpu, states = trainer_grads("cpu")
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    allow_tf32=False):
        l_ref, g_ref, _ = trainer_grads(dev, states)
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    allow_tf32=True):
        l_on, g_on, _ = trainer_grads(dev, states)
        assert torch.backends.cudnn.allow_tf32       # restored by the port
    assert abs(l_on - l_ref) <= 1e-5 * abs(l_ref)
    assert grad_rel(g_on, g_ref) <= 1e-5
    assert abs(l_on - l_cpu) <= 1e-5 * abs(l_cpu)
    assert grad_rel(g_on, g_cpu) <= 5e-4
