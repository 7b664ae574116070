"""Every model profile's DepthConvBlock widths on the card's kernels, before
the kernels: the widths each profile's models build and the ops' width
rule, the shared-memory plan at every computed width (a mirror of
``csrc/dcb_tile.cuh``'s layout asserts), the weight packing at widths that
pad, and the plain versions at those widths against the JAX package.

The JAX reference for the plain versions is the flax DepthConvBlock's XLA
conv composition (``ssgvc_tpu/layers/blocks.py``), not the Pallas kernels:
the JAX package sends these widths there itself (its Pallas gate wants C a
multiple of 128). Tolerance 1e-5 of max |ref| (fp32, another summation
order).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssgvc_tpu.layers.blocks import DepthConvBlock as JaxDCB
from ssgvc_tpu_torch import config as tcfg
from ssgvc_tpu_torch.layers import blocks as tblocks
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.ops import dcb as dcb_ops
from ssgvc_tpu_torch.ops import dcb_chain as chain_ops

PROFILES = ("tiny", "rd-tiny", "rd-mid", "rd-half")
VARIANTS = ("performance", "plain", "old", "fast", "mask_prop")
# the widths each profile's models build (every variant the same): the
# DMC's DepthConvBlocks, its chains, and the DMCI's blocks (192: dec_2 on
# the 8x8 patch's 3 x 64 channels)
WIDTHS = {"tiny": ({8, 16, 24}, {16, 24}, {8, 16, 32, 192}),
          "rd-tiny": ({16, 32, 48}, {32, 48}, {32, 48, 64, 192}),
          "rd-mid": ({32, 64, 96}, {64, 96}, {32, 64, 96, 128, 192}),
          "rd-half": ({64, 128, 160, 192}, {128, 192},
                      {64, 128, 184, 192, 256}),
          "full": ({128, 256, 320, 384}, {256, 384},
                   {128, 192, 256, 368, 512})}
PAD_WIDTHS = (8, 24, 96, 160, 184)
CSRC = Path(tcfg.__file__).resolve().parent / "csrc"


def _recorded_widths(monkeypatch, model, *args, **kw):
    """(single-block widths, chain widths) a CPU forward of ``model``
    runs."""
    single, chain = set(), set()

    def rec(store, fn):
        def wrapped(x, *a, **k):
            store.add(x.shape[-1])
            return fn(x, *a, **k)
        return wrapped

    monkeypatch.setattr(tblocks, "dcb_grad", rec(single, tblocks.dcb_grad))
    monkeypatch.setattr(tblocks, "dcb_chain_grad",
                        rec(chain, tblocks.dcb_chain_grad))
    with torch.no_grad():
        model(*args, **kw)
    return single, chain


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("profile", PROFILES + ("full",))
def test_every_profile_width_passes_the_kernels_width_rule(monkeypatch,
                                                           profile,
                                                           variant):
    dmc_cfg, dmci_cfg = tcfg.profile_model_cfgs(profile, variant)
    hw = 64
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.uniform(0, 1, s).astype(np.float32))
    dmc = DMC(dmc_cfg, device="cpu").eval()
    built = {m.dc_0.weight.shape[0] for m in dmc.modules()
             if isinstance(m, tblocks.DepthConvBlock)}
    dpb = {"frame": t(1, hw, hw, 3),
           "feature": t(1, hw // 8, hw // 8, dmc_cfg.ch_d)}
    single, chain = _recorded_widths(monkeypatch, dmc, t(1, hw, hw, 3), 20,
                                     dpb, after_i=True,
                                     mask=(t(1, hw, hw, 1) > 0.5).float())
    want_dmc, want_chain, want_dmci = WIDTHS[profile]
    assert built == want_dmc and single | chain <= built
    assert chain == want_chain
    if variant == "performance":
        dmci = DMCI(dmci_cfg, device="cpu").eval()
        single_i, chain_i = _recorded_widths(monkeypatch, dmci,
                                             t(1, hw, hw, 3), 20)
        assert single_i == want_dmci and not chain_i
    else:
        single_i = set()
    for c in built | single_i:
        dcb_ops.check_width(c, dcb_ops.MAX_CHANNELS, "dcb")
    for c in chain:
        dcb_ops.check_width(c, chain_ops.MAX_CHANNELS, "dcb_chain")


def test_the_width_rule_refuses_the_rest():
    for c in (0, 4, 12, 60, 100, 520, 1024):
        with pytest.raises(ValueError):
            dcb_ops.check_width(c, dcb_ops.MAX_CHANNELS, "dcb")
    for c in (392, 512):
        with pytest.raises(ValueError):
            dcb_ops.check_width(c, chain_ops.MAX_CHANNELS, "dcb_chain")
    for c in range(8, 513, 8):
        dcb_ops.check_width(c, dcb_ops.MAX_CHANNELS, "dcb")
    # a CPU tensor never reaches a kernel: the kernel entry raises
    with pytest.raises(ValueError, match="CUDA"):
        dcb_ops.check_input(torch.zeros(1, 8, 8, 16), "dcb", 512,
                            torch.float32)


def _cuh_constant(name):
    text = (CSRC / "dcb_tile.cuh").read_text()
    m = re.search(rf"\b{name} = (\d+)", text)
    assert m, name
    return int(m.group(1))


@pytest.mark.parametrize("cp", [64, 128, 192, 256, 320, 384, 512])
def test_shared_memory_plan_at_every_computed_width(cp):
    """``smem_bytes`` and the plan beside it mirror csrc/dcb_tile.cuh: its
    constants, its ``padded`` and the static_asserts of its ``Smem<CP>``.
    Every C from the computed width below to ``cp`` is computed at ``cp``
    (C = 392-448 at 512: there is no 448)."""
    for name in ("TILE", "WIN", "WIN_ROWS", "KC", "KF", "KS_A", "KS_B",
                 "RING_A", "BARRIER_BYTES"):
        assert _cuh_constant(name) == getattr(dcb_ops, name), name
    assert "return C > 384 ? 512 : (C + KC - 1) / KC * KC;" in (
        CSRC / "dcb_tile.cuh").read_text()
    assert cp in dcb_ops.COMPUTED_WIDTHS
    below = dict(zip(dcb_ops.COMPUTED_WIDTHS[1:],
                     dcb_ops.COMPUTED_WIDTHS)).get(cp, 0)
    for c in range(below + 8, cp + 1, 8):      # every C computed at cp
        assert dcb_ops.padded_channels(c) == cp
        assert dcb_ops.smem_bytes(c) == dcb_ops.smem_bytes(cp)
    assert not below or dcb_ops.padded_channels(below) == below
    wr, rb, slot = (dcb_ops.window_rows(cp), dcb_ops.ring_b(cp),
                    dcb_ops.slot_b(cp))
    own = dcb_ops.ring_b_own(cp)
    assert wr % 8 == 0 and wr >= dcb_ops.WIN * dcb_ops.WIN
    assert own or rb * slot <= wr * cp * 2
    assert own == (cp == 64)
    assert dcb_ops.KS_B * cp * 2 <= slot
    assert 2 * dcb_ops.KF * dcb_ops.KS_B * 2 <= slot
    assert rb * 2 + dcb_ops.RING_A * 2 + 1 <= dcb_ops.BARRIER_BYTES // 8
    assert dcb_ops.smem_bytes(cp) <= dcb_ops.SMEM_LIMIT
    # the layout's parts, summed as Smem lays them out
    parts = (wr * cp * 2 + 64 * cp * 2 + dcb_ops.RING_A * 64 * 64 * 2
             + dcb_ops.HCHUNK + (rb * slot if own else 0)
             + dcb_ops.BARRIER_BYTES)
    assert dcb_ops.smem_bytes(cp) == parts


def _np_block(c, rng):
    """Torch-layout fp32 params of one block, lecun-like, rezero tails at
    0.3 of that so the FFN and dc_3 count."""
    def t(shape, std):
        return torch.from_numpy((rng.standard_normal(shape) * std
                                 ).astype(np.float32))
    return (t((c, c, 1, 1), c ** -0.5), t((c,), 0.1),
            t((c, 1, 3, 3), 1 / 3), t((c,), 0.1),
            t((c, c, 1, 1), 0.3 * c ** -0.5), t((c,), 0.1),
            t((4 * c, c, 1, 1), c ** -0.5), t((4 * c,), 0.1),
            t((c, 2 * c, 1, 1), 0.3 * (2 * c) ** -0.5), t((c,), 0.1))


@pytest.mark.parametrize("c", PAD_WIDTHS)
def test_packing_at_padded_widths(c):
    """pack_block at a width computed at CP > C: the matrices come back at
    CP with the block's own in the top-left corner (Wf0's two halves
    apart) and zeros elsewhere; the taps and biases zero past C. pack_f32
    (the SIMT fp32 kernel's): the matrices transposed at C, then the same
    tail unpadded. The card's fp32 pack is pack_f32 at a computed width of
    64 and pack_tf32 (the 3xTF32 kernel's, at CP) above it."""
    rng = np.random.default_rng(c)
    blk = _np_block(c, rng)
    cp = dcb_ops.padded_channels(c)
    assert cp > c
    flat = dcb_ops.pack_block(blk, torch.float32)
    assert flat.numel() == dcb_ops.packed_numel(c)
    mats = dcb_ops.unpack_block(flat, c)
    w0, b0, w2, b2, w3, b3, wf0, bf0, wf2, bf2 = blk
    wf0 = wf0[:, :, 0, 0]
    want = {"w0": (w0[:, :, 0, 0], (0, 0)), "w3": (w3[:, :, 0, 0], (0, 0)),
            "wf2": (wf2[:, :, 0, 0], (0, 0))}
    for k, (m, _) in want.items():
        got = mats[k]
        torch.testing.assert_close(got[:m.shape[0], :m.shape[1]], m,
                                   rtol=0, atol=0)
        rest = got.clone()
        rest[:m.shape[0], :m.shape[1]] = 0
        assert not rest.any(), k
    got = mats["wf0"]
    torch.testing.assert_close(got[:2 * c, :c], wf0[:2 * c], rtol=0, atol=0)
    torch.testing.assert_close(got[2 * cp:2 * cp + 2 * c, :c], wf0[2 * c:],
                               rtol=0, atol=0)
    rest = got.clone()
    rest[:2 * c, :c] = 0
    rest[2 * cp:2 * cp + 2 * c, :c] = 0
    assert not rest.any()
    tail = flat[8 * cp * cp:]
    rows = torch.cat([tail[:12 * cp], tail[16 * cp:]]).reshape(13, cp)
    assert not rows[:, c:].any()            # taps, b0, b2, b3, bf2
    torch.testing.assert_close(rows[:9, :c], w2.reshape(c, 9).t(), rtol=0,
                               atol=0)
    bf0_p = tail[12 * cp:16 * cp]
    want_bf0 = torch.zeros(4 * cp)
    want_bf0[:2 * c], want_bf0[2 * cp:2 * cp + 2 * c] = bf0[:2 * c], bf0[2 * c:]
    torch.testing.assert_close(bf0_p, want_bf0, rtol=0, atol=0)

    f32 = dcb_ops.pack_f32(blk)
    assert f32.numel() == 8 * c * c + 17 * c
    tf32 = dcb_ops.uses_tf32(c)
    assert dcb_ops.packed_numel(c, torch.float32) == (
        16 * cp * cp + 17 * cp if tf32 else f32.numel())
    off = 0
    for m in (w0, w3, wf0[..., None, None], wf2):
        m = m[:, :, 0, 0]
        n = m.numel()
        torch.testing.assert_close(f32[off:off + n].reshape(m.shape[1],
                                                            m.shape[0]),
                                   m.t(), rtol=0, atol=0)
        off += n
    torch.testing.assert_close(
        f32[off:], dcb_ops.pack_params(blk, torch.float32)[off:], rtol=0,
        atol=0)
    # the card's pack for each dtype
    torch.testing.assert_close(dcb_ops.pack_kernel(blk, torch.float32),
                               dcb_ops.pack_tf32(blk) if tf32 else f32,
                               rtol=0, atol=0)
    torch.testing.assert_close(dcb_ops.pack_kernel(blk, torch.bfloat16),
                               dcb_ops.pack_block(blk, torch.bfloat16),
                               rtol=0, atol=0)


def _flax(blk):
    """The port's params as a flax DepthConvBlock's (OIHW -> HWIO)."""
    names = ("dc_0", "dc_2", "dc_3", "ffn_0", "ffn_2")
    return {n: {"kernel": jnp.asarray(blk[2 * i].numpy().transpose(2, 3, 1, 0)),
                "bias": jnp.asarray(blk[2 * i + 1].numpy())}
            for i, n in enumerate(names)}


def _max_rel(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("c", PAD_WIDTHS)
@pytest.mark.parametrize("shortcut,with_q", [(False, False), (True, True)])
def test_plain_block_matches_the_jax_block_at_padded_widths(c, shortcut,
                                                            with_q):
    rng = np.random.default_rng(c + 1)
    blk = _np_block(c, rng)
    x = rng.standard_normal((2, 9, 13, c)).astype(np.float32)
    q = np.linspace(0.5, 1.5, c, dtype=np.float32) if with_q else None
    ref = JaxDCB(c, shortcut=shortcut).apply(
        {"params": _flax(blk)}, jnp.asarray(x),
        None if q is None else jnp.asarray(q))
    out = dcb_ops.dcb_plain(torch.from_numpy(x), blk,
                            None if q is None else torch.from_numpy(q),
                            shortcut)
    assert _max_rel(out.numpy(), np.asarray(ref)) <= 1e-5


@pytest.mark.parametrize("c", (8, 24, 96, 160))
def test_plain_chain_matches_the_jax_blocks_at_padded_widths(c):
    rng = np.random.default_rng(c + 2)
    blocks = [_np_block(c, rng) for _ in range(3)]
    x = rng.standard_normal((2, 9, 13, c)).astype(np.float32)
    q = np.linspace(0.5, 1.5, c, dtype=np.float32)
    ref = jnp.asarray(x)
    for j, blk in enumerate(blocks):
        ref = JaxDCB(c).apply({"params": _flax(blk)}, ref,
                              jnp.asarray(q) if j == 2 else None)
    out = chain_ops.dcb_chain_plain(torch.from_numpy(x), blocks,
                                    torch.from_numpy(q))
    assert _max_rel(out.numpy(), np.asarray(ref)) <= 1e-5
