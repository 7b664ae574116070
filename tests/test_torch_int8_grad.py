"""The gradient of the port's int8 route (``SSGVC_INT8``) against
``jax.grad`` of the JAX package, on the CPU.

The JAX package's QuantConv casts to int8, which carries no gradient, so
``jax.grad`` flows only through the bias and, by out = y * (s_x * s_w) + b,
through the scales: to the kernel elements at each output channel's
abs-max and, in mode 1, to x's elements at its abs-max; ties split evenly.
The port's ``ops.qconv.qconv_grad`` computes the same.

Tolerances: one ``Conv`` against ``jax.grad`` of QuantConv on the same
parameters at 1e-5 relative (of the gradient's largest element), with the
non-zero support equal: the sums over the output are fp32 in another
order. The tiny DMC's training loss gradient under ``SSGVC_INT8=1``
against the JAX trainer's on the same weights and batch by
test_torch_training's rule (each tensor within GRAD_TENSOR_TOL of its
norm, the whole within 1e-3).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import DMC_HEADS, DMCI_HEADS
from ssgvc_tpu import config as jcfg
from ssgvc_tpu.layers import blocks as jb
from ssgvc_tpu.training.trainer import Trainer as JaxTrainer
from ssgvc_tpu_torch.config import TrainConfig
from ssgvc_tpu_torch.data.device_synth import synth_batch
from ssgvc_tpu_torch.layers import blocks as pb
from ssgvc_tpu_torch.ops import qconv as Q
from ssgvc_tpu_torch.training.trainer import Trainer
from ssgvc_tpu_torch.utils.weights import flatten, flax_from_state_dict
from test_torch_training import GRAD_TENSOR_TOL
from torch_port_helpers import drawn_params

REL = 1e-5
#: (kernel, stride, padding) of the sites: 1x1, 3x3, 3x3 stride 2
SITES = [(1, 1, 0), (3, 1, 1), (3, 2, 1)]
STATIC_ABSMAX = 1.7          # mode 2's calibrated abs-max (x is N(0, 1))


@pytest.fixture(autouse=True)
def int8_state():
    """Both packages' scale tables empty for the test, restored after."""
    saved = (dict(jb._INT8_SCALES), set(jb._INT8_BAKED),
             dict(pb._INT8_SCALES))
    for t in (jb._INT8_SCALES, jb._INT8_BAKED, pb._INT8_SCALES):
        t.clear()
    yield
    for t, old in zip((jb._INT8_SCALES, jb._INT8_BAKED, pb._INT8_SCALES),
                      saved):
        t.clear()
        t.update(old)


def _site_case(k, s, tie, seed=0):
    rng = np.random.default_rng(seed + 10 * k + s)
    cin, o = 6, 5
    x = rng.standard_normal((2, 10, 12, cin)).astype(np.float32)
    kern = (rng.standard_normal((k, k, cin, o)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(o) * 0.1).astype(np.float32)
    r = rng.standard_normal((2, (10 + 2 * (k // 2) - k) // s + 1,
                             (12 + 2 * (k // 2) - k) // s + 1, o)
                            ).astype(np.float32)
    if tie:
        # two elements of x and of output channel 1's kernel at the
        # abs-max, of opposite signs
        x[0, 1, 2, 3], x[1, 7, 4, 0] = 4.5, -4.5
        kern[..., 1] = np.clip(kern[..., 1], -0.5, 0.5)
        kern.reshape(-1, o)[0, 1], kern.reshape(-1, o)[-1, 1] = 0.9, -0.9
    return x, kern, b, r


def _jax_grads(x, kern, b, r, k, s, p):
    mod = jb.QuantConv(features=kern.shape[-1], kernel_size=(k, k),
                       strides=(s, s), padding=[(p, p), (p, p)])

    def loss(kk, bb, xx):
        out = mod.apply({"params": {"kernel": kk, "bias": bb}}, xx)
        return jnp.sum(out * jnp.asarray(r))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(kern), jnp.asarray(b), jnp.asarray(x))]


def _port_grads(x, kern, b, r, k, s, p):
    conv = pb.Conv(kern.shape[2], kern.shape[3], k, stride=s, padding=p,
                   device="cpu")
    conv.site = ""                      # the root module's key, as JAX's
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kern.transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = conv(xt)
    (out * torch.from_numpy(r)).sum().backward()
    gx = torch.zeros_like(xt) if xt.grad is None else xt.grad
    return [conv.weight.grad.permute(2, 3, 1, 0).numpy(),
            conv.bias.grad.numpy(), gx.numpy()]


def _hold(got, ref, what):
    scale = float(np.abs(ref).max())
    np.testing.assert_array_equal(got != 0, ref != 0,
                                  err_msg=f"{what}: support")
    np.testing.assert_allclose(got, ref, rtol=REL, atol=REL * scale,
                               err_msg=what)


@pytest.mark.parametrize("tie", [False, True], ids=["", "tie"])
@pytest.mark.parametrize("mode", ["1", "2"])
@pytest.mark.parametrize("site", SITES, ids=lambda s: "k%ds%dp%d" % s)
def test_int8_conv_gradient_matches_jax_grad(monkeypatch, site, mode, tie):
    """Weight, bias and input gradients of one fp32 int8 Conv against
    ``jax.grad`` of QuantConv: the kernel's support is one element per
    output channel (two on the tied channel), x's one element (two tied)
    in mode 1 and none in mode 2."""
    torch.set_num_threads(1)
    k, s, p = site
    case = _site_case(k, s, tie)
    monkeypatch.setenv("SSGVC_INT8", mode)
    if mode == "2":
        jb._INT8_SCALES[""] = STATIC_ABSMAX
        pb._INT8_SCALES[""] = STATIC_ABSMAX
    ref = _jax_grads(*case, k, s, p)
    got = _port_grads(*case, k, s, p)
    for what, a, b in zip(("kernel", "bias", "x"), got, ref):
        _hold(a, b, what)
    assert (ref[0] != 0).sum() == ref[0].shape[-1] + tie
    assert (ref[2] != 0).sum() == ((1 + tie) if mode == "1" else 0)


def test_int8_backward_recomputes_the_sums_and_follows_updates(monkeypatch):
    """The backward takes the int32 sums from a second launch of the conv
    (unit scales, zero bias, fp32 out) on x's int8 values: one forward and
    one backward launch per site, both through ``ops.qconv.qconv``; the
    cached quantized weight follows an in-place optimizer update."""
    monkeypatch.setenv("SSGVC_INT8", "1")
    k, s, p = SITES[1]
    x, kern, b, r = _site_case(k, s, False)
    calls = []
    real = Q.qconv

    def counting(*a, **kw):
        calls.append((a[5], a[6], tuple(a[7])))
        return real(*a, **kw)

    monkeypatch.setattr(Q, "qconv", counting)
    monkeypatch.setattr(pb, "qconv", counting)
    conv = pb.Conv(6, 5, k, stride=s, padding=p, device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kern.transpose(3, 2, 0, 1)))
    opt = torch.optim.SGD(conv.parameters(), lr=0.5)
    wq0 = conv.int8_weight()[0].clone()
    (conv(torch.from_numpy(x)) * torch.from_numpy(r)).sum().backward()
    assert calls == [(k, s, (p, p, p, p))] * 2
    opt.step()
    assert not torch.equal(conv.int8_weight()[0], wq0)
    assert torch.equal(conv.int8_weight()[0],
                       Q.quantize_weight(conv.weight)[0])


# ------------------------------------------- the tiny DMC's loss gradient --

@functools.lru_cache(maxsize=1)
def _loss_case():
    """The tiny fp32 trainer on drawn weights, a B=2 T=2 batch, the DPB of
    the port's I-frame, and the JAX trainer's P-frame loss gradient on them
    under SSGVC_INT8=1 (train=False, QP 20), op by op: under ``jit`` XLA
    rewrites QuantConv's x / s_x, which moves int8 roundings and with them
    the abs-max elements the gradient flows through (the whole gradient
    then sat 0.2 of its norm from the op-by-op one, on these weights)."""
    cfg = TrainConfig(accumulation_steps=1)
    cfg.model_profile, cfg.precision = "tiny", "32"
    tr = Trainer(cfg, total_iters=100, device="cpu")
    pi = drawn_params(tr.dmci, 0, DMCI_HEADS)
    pp = drawn_params(tr.dmc, 1, DMC_HEADS)
    del pi
    batch = synth_batch(torch.Generator().manual_seed(5), batch=2, size=64,
                        seq_len=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SSGVC_INT8", "1")
        with torch.no_grad():
            i_out = tr.dmci(batch["frames"][:, 0], 20, train=False)
        dpb = {"frame": i_out["dpb"]["frame"],
               "feature": tr._zero_feature(batch["frames"])}
        jc = jcfg.TrainConfig(accumulation_steps=1)
        jc.model_profile, jc.precision = "tiny", "fp32"
        jt = JaxTrainer(jc, total_iters=100)
        frames, masks = (jnp.asarray(batch[k].numpy())
                         for k in ("frames", "masks"))
        jdpb = {k: jnp.asarray(v.numpy()) for k, v in dpb.items()}
        f = lambda p: jt._p_frame_losses(
            p, frames, masks, jnp.int32(20), jdpb, jax.random.PRNGKey(1),
            False, False)[0].mean(axis=0)[0]
        loss, grads = jax.value_and_grad(f)(
            jax.tree_util.tree_map(jnp.asarray, pp))
    return tr, batch, dpb, float(loss), {
        k: np.asarray(v) for k, v in flatten(grads).items()}


def test_tiny_dmc_int8_loss_gradient_matches_jax(monkeypatch):
    """The tiny DMC's P-frame training loss under SSGVC_INT8=1 (mode 1:
    every 1x1 and 3x3 on the int8 route, the blocks as the JAX
    composition) and its gradient against ``jax.grad`` of the JAX
    trainer's on the same weights, batch and DPB."""
    torch.set_num_threads(1)
    tr, batch, dpb, jloss, jgrads = _loss_case()
    monkeypatch.setenv("SSGVC_INT8", "1")
    tr.dmc.zero_grad(set_to_none=True)
    metrics = tr._p_frame_losses(batch["frames"], batch["masks"], 20, dpb,
                                 torch.Generator().manual_seed(1), False,
                                 False)
    loss = metrics.mean(dim=0)[0]
    tr.backward(loss)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-6)
    named = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in tr.dmc.named_parameters()}
    got = {k: np.asarray(v) for k, v in flatten(flax_from_state_dict(
        named)).items()}
    assert set(got) == set(jgrads)
    err2 = norm2 = 0.0
    nonzero = 0
    for k, ref in jgrads.items():
        err = float(np.linalg.norm(got[k].astype(np.float64) - ref))
        scale = float(np.linalg.norm(ref.astype(np.float64)))
        assert err <= GRAD_TENSOR_TOL * scale or (scale == 0 and err == 0), \
            (k, err, scale)
        nonzero += scale > 0
        err2, norm2 = err2 + err ** 2, norm2 + scale ** 2
    assert np.sqrt(err2 / norm2) <= 1e-3
    assert nonzero > 0.8 * len(jgrads)
