"""The plain versions of the port's two DepthConvBlock kernels against the
JAX package's Pallas kernels (interpret mode on the CPU), the segment
planner, and the CPU routing. Kernel-vs-plain on the card lives in
test_torch_kernels_gpu.py.

Tolerances as the Pallas kernels' own tests: atol 2e-5 for one block, 3e-5
for a chain (fp32, another summation order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssgvc_tpu.layers.blocks import DepthConvBlock as JaxDCB
from ssgvc_tpu.ops.pallas_dcb import dcb_fused
from ssgvc_tpu.ops.pallas_dcb_chain import dcb_chain_fused
from ssgvc_tpu_torch.ops import dcb as dcb_ops
from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
from torch_port_helpers import perturbed

NAMES = ("dc_0", "dc_2", "dc_3", "ffn_0", "ffn_2")


def _flax_block(c, seed):
    p = JaxDCB(c).init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, 8, 16, c)))["params"]
    p = perturbed(p, seed=seed + 100)
    return tuple(a for nm in NAMES for a in (p[nm]["kernel"], p[nm]["bias"]))


def _torch_block(flax_block):
    """flax layouts -> the port's: kernels HWIO -> OIHW, biases as is."""
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a.transpose(3, 2, 0, 1) if a.ndim == 4 else a))
        for a in flax_block)


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("shortcut,with_q", [(False, False), (True, True)])
def test_plain_dcb_matches_pallas_kernel(shortcut, with_q):
    c, h, w = 128, 12, 16
    x = _x((1, h, w, c), 3)
    q = (np.linspace(0.5, 1.5, c, dtype=np.float32).reshape(1, 1, 1, c)
         if with_q else None)
    blk = _flax_block(c, 0)
    ref = dcb_fused(jnp.asarray(x), *map(jnp.asarray, blk),
                    q=None if q is None else jnp.asarray(q),
                    shortcut=shortcut)
    out = dcb_ops.dcb_plain(torch.from_numpy(x), _torch_block(blk),
                            None if q is None else torch.from_numpy(q),
                            shortcut)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("n,h,with_q,scale", [
    (2, 12, False, 0.5), (3, 12, False, 0.5), (4, 16, False, 0.5),
    (2, 8, True, 0.5),        # q_last folded into the last block
    (3, 24, False, 1.0),      # several Pallas row tiles: edge masking
])
def test_plain_chain_matches_pallas_kernel(n, h, with_q, scale):
    c, w = 128, 16
    x = _x((1, h, w, c), 7 + n, scale)
    q = (np.linspace(0.5, 1.5, c, dtype=np.float32).reshape(1, 1, 1, c)
         if with_q else None)
    blocks = [_flax_block(c, j) for j in range(n)]
    ref = dcb_chain_fused(jnp.asarray(x),
                          [tuple(map(jnp.asarray, b)) for b in blocks],
                          q_last=None if q is None else jnp.asarray(q))
    out = chain_ops.dcb_chain_plain(
        torch.from_numpy(x), [_torch_block(b) for b in blocks],
        None if q is None else torch.from_numpy(q))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    c = 128
    blocks = [_torch_block(_flax_block(c, j)) for j in range(2)]
    x = torch.from_numpy(_x((1, 6, 5, c), 1))
    q = torch.linspace(0.5, 1.5, c)
    before = (dcb_ops.launches, chain_ops.launches)
    y1 = dcb_ops.dcb(x, blocks[0], q, shortcut=True)
    y2 = chain_ops.dcb_chain(x, blocks, q)
    assert (dcb_ops.launches, chain_ops.launches) == before
    torch.testing.assert_close(y1, dcb_ops.dcb_plain(x, blocks[0], q, True),
                               rtol=0, atol=0)
    torch.testing.assert_close(y2, chain_ops.dcb_chain_plain(x, blocks, q),
                               rtol=0, atol=0)
    # the kernel entry never takes a CPU tensor: it raises, no fallback
    with pytest.raises(ValueError):
        dcb_ops.dcb_cuda(x.to(torch.bfloat16),
                         dcb_ops.pack_params(blocks[0], torch.bfloat16))


def test_planner_fits_every_main_path_site_in_one_launch():
    for c in dcb_ops.KERNEL_CHANNELS:
        assert dcb_ops.plan_tile(c, 1) == (8, 8)
    # the chains of the main path: one segment each
    for c, n in ((256, 2), (256, 4), (384, 3)):
        plan = chain_ops.plan_segments(c, n)
        assert len(plan) == 1 and plan[0][0] == n
        assert dcb_ops.smem_bytes(c, *plan[0]) <= dcb_ops.SMEM_LIMIT
    # a chain no tile fits whole is split, longest segment first
    plan = chain_ops.plan_segments(384, 8)
    assert len(plan) > 1 and sum(n for n, _, _ in plan) == 8
    assert [n for n, _, _ in plan] == sorted((n for n, _, _ in plan),
                                            reverse=True)
    for n, th, tw in plan:
        assert dcb_ops.smem_bytes(384, n, th, tw) <= dcb_ops.SMEM_LIMIT


def test_packed_params_layout():
    c = 128
    blk = _torch_block(_flax_block(c, 0))
    packed = dcb_ops.pack_params(blk, torch.float32)
    assert packed.numel() == dcb_ops.packed_numel(c)
    w0, b0, w2, b2, w3, b3, wf0, bf0, wf2, bf2 = blk
    off = 8 * c * c
    torch.testing.assert_close(packed[:c * c].reshape(c, c), w0[:, :, 0, 0])
    torch.testing.assert_close(packed[2 * c * c:6 * c * c].reshape(4 * c, c),
                               wf0[:, :, 0, 0])
    torch.testing.assert_close(packed[off:off + 9 * c].reshape(3, 3, c),
                               w2[:, 0].permute(1, 2, 0))
    torch.testing.assert_close(packed[-c:], bf2)
