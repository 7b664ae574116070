"""The fp32 DepthConvBlock kernel's plan on the CPU: the 3xTF32 split and
weight layout of ``ops/dcb.py`` (what ``csrc/dcb_tf32.cu`` streams), its
shared-memory plan, a torch emulation of its products on masked mantissas
against the plain fp32 block, and the fixed order of ``grad_reduce``
(``csrc/dcb_bwd.cu``) against ``part.sum(0)``.

Tolerances: hi + lo keeps 22 bits of a weight (within 2^-22 |w|); the
emulated block is held at the fp32 kernels' 1e-5 of max |ref| (3xTF32
drops each product's lo x lo term, ~2^-22 relative, and sums in another
order); the reduction at 1e-5 of the sum's largest magnitude (fp32 sums in
another order).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssgvc_tpu_torch.ops import dcb as dcb_ops
from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
from ssgvc_tpu_torch.ops import dcb_grad as dg
from torch_port_helpers import one_torch_thread  # noqa: F401

F32_TOL = 1e-5
CSRC = Path(dcb_ops.__file__).resolve().parent.parent / "csrc"
# one width per computed width of the 3xTF32 kernel, padded and not (the
# narrow ones route to the SIMT kernel, but the 3xTF32 one takes them)
TF32_WIDTHS = (8, 64, 72, 96, 128, 160, 192, 256, 320, 368, 384, 448, 512)


def block(c, rng):
    def t(shape, std):
        return torch.from_numpy((rng.standard_normal(shape) * std
                                 ).astype(np.float32))
    return (t((c, c, 1, 1), c ** -0.5), t((c,), 0.1),
            t((c, 1, 3, 3), 1 / 3), t((c,), 0.1),
            t((c, c, 1, 1), 0.3 * c ** -0.5), t((c,), 0.1),
            t((4 * c, c, 1, 1), c ** -0.5), t((4 * c,), 0.1),
            t((c, 2 * c, 1, 1), 0.3 * (2 * c) ** -0.5), t((c,), 0.1))


def low_bits(t):
    return t.contiguous().view(torch.int32) & 0x1FFF


# ------------------------------------------------------------- the split

@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0, 3e3])
def test_split_halves_are_tf32_exact(scale):
    rng = np.random.default_rng(int(scale * 1e6) % 997)
    w = torch.from_numpy((rng.standard_normal(20000) * scale
                          ).astype(np.float32))
    hi, lo = dcb_ops.tf32_split(w)
    assert not low_bits(hi).any() and not low_bits(lo).any()
    err = (hi.double() + lo.double() - w.double()).abs()
    assert bool((err <= 2.0 ** -22 * w.double().abs()).all())


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                   # tf32's spacing at 1
    cases = {one + ulp / 2: one + ulp, one + ulp / 2 - 2 ** -23: one,
             -(one + ulp / 2): -(one + ulp), one + 3 * ulp / 4: one + ulp,
             0.0: 0.0}
    got = dcb_ops.rna_tf32(torch.tensor(list(cases), dtype=torch.float32))
    assert got.tolist() == list(cases.values())


def test_k_order_permutes_each_k16_block():
    order = dcb_ops.tf32_k_order(64)
    assert sorted(order.tolist()) == list(range(64))
    # a thread's float4 of channels 4j..4j+3 feeds columns j and j + 4 of
    # step 0, then of step 1
    for j in range(4):
        assert order[[j, j + 4, 8 + j, 12 + j]].tolist() == [4 * j + i
                                                             for i in range(4)]
    assert (order.reshape(4, 16) - torch.arange(0, 64, 16)[:, None]
            ).eq(order[:16]).all()


@pytest.mark.parametrize("r,k", [(64, 16), (96, 128), (8, 32)])
def test_steps_layout_offsets(r, k):
    """Element (n, kl) of step s's hi lies at (n / 8) 64 + (kl / 4) 32 +
    (n % 8) 4 + kl % 4 of the step's first 8 r floats, lo 8 r further."""
    rng = np.random.default_rng(r + k)
    m = torch.from_numpy(rng.standard_normal((r, k)).astype(np.float32))
    flat = dcb_ops.tf32_steps(m)
    assert flat.numel() == 2 * r * k
    order = dcb_ops.tf32_k_order(k)
    hi, lo = dcb_ops.tf32_split(m)
    for s in (0, k // 8 - 1):
        for n in (0, 5, r - 1):
            for kl in (0, 3, 4, 7):
                at = s * 16 * r + (n // 8) * 64 + (kl // 4) * 32 \
                    + (n % 8) * 4 + kl % 4
                ch = order[8 * s + kl]
                assert flat[at] == hi[n, ch]
                assert flat[at + 8 * r] == lo[n, ch]
    torch.testing.assert_close(dcb_ops.tf32_unsteps(flat, r, k), m,
                               rtol=2.0 ** -22, atol=0)


# ------------------------------------------------------------ the packing

@pytest.mark.parametrize("c", TF32_WIDTHS)
def test_pack_tf32_at_every_width(c):
    """pack_tf32 at C's computed width: its size, its matrices (hi + lo
    within 2^-22 of the padded block's), its tail, the route."""
    rng = np.random.default_rng(c)
    blk = block(c, rng)
    cp = dcb_ops.tf32_width(c)
    assert cp == max(dcb_ops.padded_channels(c), dcb_ops.TF32_MIN_CP)
    flat = dcb_ops.pack_tf32(blk)
    assert flat.numel() == dcb_ops.tf32_numel(c) == 16 * cp * cp + 17 * cp
    assert dcb_ops.uses_tf32(c) == (c > 64)
    assert not low_bits(flat[:16 * cp * cp]).any()
    want = dcb_ops._matrices(dcb_ops.pad_params(blk, cp))
    got = dcb_ops.unpack_tf32(flat, c)
    for k, m in want.items():
        err = (got[k].double() - m.double()).abs()
        assert bool((err <= 2.0 ** -22 * m.double().abs()).all()), k
    padded = dcb_ops.pack_params(dcb_ops.pad_params(blk, cp), torch.float32)
    torch.testing.assert_close(flat[16 * cp * cp:], padded[8 * cp * cp:],
                               rtol=0, atol=0)
    if dcb_ops.uses_tf32(c):
        assert dcb_ops.packed_numel(c, torch.float32) == flat.numel()
        torch.testing.assert_close(dcb_ops.pack_kernel(blk, torch.float32),
                                   flat, rtol=0, atol=0)


@pytest.mark.parametrize("c", [8, 32, 64])
def test_narrow_fp32_widths_keep_the_simt_packing(c):
    blk = block(c, np.random.default_rng(c))
    assert not dcb_ops.uses_tf32(c)
    packed = dcb_ops.pack_kernel(blk, torch.float32)
    assert packed.numel() == dcb_ops.packed_numel(c, torch.float32) \
        == 8 * c * c + 17 * c
    torch.testing.assert_close(packed, dcb_ops.pack_f32(blk), rtol=0,
                               atol=0)


def slab_contents(c):
    """What each warpgroup's slabs of one tile must hold, in order, from the
    kernel's loops: (matrix, rows, first k, k8 steps from, k8 steps)."""
    cp = dcb_ops.tf32_width(c)
    (sa, sb), ks, half = dcb_ops.tf32_sps(c), cp // 8, cp // 2
    out = {}
    for g in range(2):
        rows_out = list(range(g * half, (g + 1) * half))
        seq = []
        for c0 in range(0, cp, dcb_ops.T_KC):
            seq += [("w0", list(range(c0, c0 + 64)), 0, s, sa)
                    for s in range(0, ks, sa)]
        seq += [("w3", rows_out, 0, s, sb) for s in range(0, ks, sb)]
        for f0 in range(0, 2 * cp, dcb_ops.T_KF):
            rows_f = dcb_ops.ffn_rows(cp, f0)[64 * g:64 * (g + 1)]
            seq += [("wf0", rows_f, 0, s, sa) for s in range(0, ks, sa)]
            seq += [("wf2", rows_out, f0, s, sb) for s in range(0, 8, sb)]
        out[g] = seq
    return out


def decode_streams(flat, c):
    """The block's weights hi and lo ([out][in], at CP), read slab by slab
    through the kernel's byte offsets (tf32_stream) and its loops."""
    cp = dcb_ops.tf32_width(c)
    shapes = {"w0": (cp, cp), "w3": (cp, cp), "wf0": (4 * cp, cp),
              "wf2": (cp, 2 * cp)}
    his = {k: torch.full(v, float("nan")) for k, v in shapes.items()}
    los = {k: torch.full(v, float("nan")) for k, v in shapes.items()}
    order16 = dcb_ops.tf32_k_order(16)
    for g, seq in slab_contents(c).items():
        stream = dcb_ops.tf32_stream(c, g)
        assert len(stream) == len(seq)
        for (off, nbytes), (name, rows, k0, s0, steps) in zip(stream, seq):
            r = len(rows)
            assert nbytes == steps * 2 * r * 8 * 4
            assert nbytes <= dcb_ops.tf32_slot_bytes(c)
            assert off % 16 == 0
            slab = flat[off // 4:(off + nbytes) // 4].reshape(steps, 2, r * 8)
            for t in range(steps):
                s = s0 + t
                chans = k0 + 16 * (s // 2) + order16[8 * (s % 2):
                                                     8 * (s % 2) + 8]
                for half, dst in ((0, his), (1, los)):
                    m = slab[t, half].reshape(r // 8, 2, 8, 4) \
                        .permute(0, 2, 1, 3).reshape(r, 8)
                    if name == "w0" and g == 1:     # both stream W0
                        assert torch.equal(
                            dst[name][rows][:, chans], m)
                    block_ = dst[name][rows]
                    block_[:, chans] = m
                    dst[name][rows] = block_
    return his, los


@pytest.mark.parametrize("c", [32, 96, 192, 256, 320, 512])
def test_stream_offsets_read_the_packing(c):
    """Walking both warpgroups' slab offsets (Stream::src) with the kernel's
    loop structure reads every weight of pack_tf32 once (W0 once per
    warpgroup), hi and lo in their places."""
    rng = np.random.default_rng(c + 1)
    blk = block(c, rng)
    cp = dcb_ops.tf32_width(c)
    flat = dcb_ops.pack_tf32(blk)
    his, los = decode_streams(flat, c)
    want = dcb_ops._matrices(dcb_ops.pad_params(blk, cp))
    for k, m in want.items():
        hi, lo = dcb_ops.tf32_split(m)
        assert torch.equal(his[k], hi), k
        assert torch.equal(los[k], lo), k
    # the stream's bytes: W0 once, then each warpgroup's 7 CP^2 floats
    ends = [off + n for g in (0, 1) for off, n in dcb_ops.tf32_stream(c, g)]
    assert max(ends) == 16 * cp * cp * 4


@pytest.mark.parametrize("cp", dcb_ops.COMPUTED_WIDTHS[1:])
def test_tf32_shared_memory_plan(cp):
    """csrc/dcb_tf32.cu's plan at every computed width it takes: within the
    232,448 bytes a block may use, at least two slots a ring, whole slabs
    of whole k8 steps in a slot."""
    (sa, sb), slot = dcb_ops.tf32_sps(cp), dcb_ops.tf32_slot_bytes(cp)
    slots = dcb_ops.tf32_slots(cp)
    assert dcb_ops.tf32_smem_bytes(cp) <= dcb_ops.SMEM_LIMIT
    assert 2 <= slots <= dcb_ops.T_MAX_SLOTS
    assert (cp // 8) % sa == 0 and 4096 * sa <= slot
    assert (cp // 8) % sb == 0 and 8 % sb == 0 and 32 * cp * sb <= slot
    assert dcb_ops.T_NWIN * dcb_ops.T_HS * 4 <= dcb_ops.T_XBUF
    text = (CSRC / "dcb_tf32.cu").read_text()
    for name, value in (("KC", dcb_ops.T_KC), ("KF", dcb_ops.T_KF),
                        ("MAX_SLOTS", dcb_ops.T_MAX_SLOTS),
                        ("BAR_BYTES", dcb_ops.BARRIER_BYTES),
                        ("SMEM_LIMIT", dcb_ops.SMEM_LIMIT)):
        m = re.search(rf"\b{name} = (\d+)", text)
        assert m and int(m.group(1)) == value, name
    assert "HS = KC + 4" in text and "XBUF = 2 * NPIX * KF * 4" in text
    assert "return C > 384 ? 512 : C <= 128 ? 128 : (C + 63) / 64 * 64;" \
        in text
    want = {128: 229632, 192: 229632, 256: 229632, 320: 217344,
            384: 229632, 512: 229632}
    assert dcb_ops.tf32_smem_bytes(cp) == want[cp]


# ------------------------------------------------- the numeric plan

def mm3(a, hi, lo):
    """a @ W^T in 3xTF32: a split hi / lo, a_hi W_hi + a_hi W_lo + a_lo
    W_hi, the tf32 products exact, summed in double then rounded."""
    ah, al = dcb_ops.tf32_split(a)
    ah, al, hi, lo = (t.double() for t in (ah, al, hi, lo))
    return (ah @ hi.t() + ah @ lo.t() + al @ hi.t()).float()


def emulate_block(x, flat, q, shortcut):
    """One block as csrc/dcb_tf32.cu computes it, at CP with masked
    mantissas, its weights read through the kernel's stream offsets."""
    c = x.shape[-1]
    cp = dcb_ops.tf32_width(c)
    his, los = decode_streams(flat, c)
    tail = flat[16 * cp * cp:]
    taps, b0, b2, b3 = (tail[:9 * cp].reshape(9, cp), tail[9 * cp:10 * cp],
                        tail[10 * cp:11 * cp], tail[11 * cp:12 * cp])
    bf0, bf2 = tail[12 * cp:16 * cp], tail[16 * cp:]
    xp = F.pad(x, (0, cp - c))
    h = dcb_ops.wsilu(mm3(xp, his["w0"], los["w0"]) + b0)
    g = F.conv2d(h.permute(0, 3, 1, 2), taps.t().reshape(cp, 1, 3, 3), b2,
                 padding=1, groups=cp).permute(0, 2, 3, 1)
    u = xp + mm3(g, his["w3"], los["w3"]) + b3
    p = mm3(u, his["wf0"], los["wf0"]) + bf0
    f = dcb_ops.wsilu(p[..., :2 * cp]) + dcb_ops.wsilu(p[..., 2 * cp:])
    y = u + bf2 + mm3(f, his["wf2"], los["wf2"])
    y = y[..., :c]
    if shortcut:
        y = y + x
    if q is not None:
        y = y * q
    return y


@pytest.mark.parametrize("c,shortcut,with_q", [(40, False, True),
                                               (72, True, True),
                                               (96, False, False),
                                               (128, True, False),
                                               (160, False, True)])
def test_emulated_3xtf32_block_matches_plain(c, shortcut, with_q):
    rng = np.random.default_rng(c + 3)
    blk = block(c, rng)
    x = torch.from_numpy(rng.standard_normal((2, 9, 13, c)
                                             ).astype(np.float32))
    q = torch.linspace(0.5, 1.5, c) if with_q else None
    out = emulate_block(x, dcb_ops.pack_tf32(blk), q, shortcut)
    ref = dcb_ops.dcb_plain(x, blk, q, shortcut)
    assert float((out - ref).abs().max() / ref.abs().max()) <= F32_TOL


def test_emulated_3xtf32_chain_matches_plain():
    """The chain's per-block weights are pack_tf32's back to back."""
    c = 96
    rng = np.random.default_rng(5)
    blocks = [block(c, rng) for _ in range(3)]
    x = torch.from_numpy(rng.standard_normal((1, 11, 8, c)
                                             ).astype(np.float32))
    q = torch.linspace(0.5, 1.5, c)
    packed = chain_ops.pack_chain(blocks, torch.float32)
    per = dcb_ops.packed_numel(c, torch.float32)
    assert packed.numel() == 3 * per
    y = x
    for j in range(3):
        y = emulate_block(y, packed[j * per:(j + 1) * per],
                          q if j == 2 else None, False)
    ref = chain_ops.dcb_chain_plain(x, blocks, q)
    assert float((y - ref).abs().max() / ref.abs().max()) <= F32_TOL


def test_tf32_wrappers_refuse_cpu_tensors():
    rng = np.random.default_rng(0)
    x = torch.zeros((1, 8, 8, 128))
    packed = dcb_ops.pack_tf32(block(128, rng))
    with pytest.raises(ValueError):
        dcb_ops.dcb_tf32_cuda(x, packed)            # not a CUDA tensor
    with pytest.raises(ValueError):
        chain_ops.dcb_chain_tf32_cuda(x, packed)
    # the CPU path is the plain version on both routes
    for c in (64, 128):
        blk = block(c, rng)
        xc = torch.from_numpy(rng.standard_normal((1, 5, 6, c)
                                                  ).astype(np.float32))
        assert torch.equal(dcb_ops.dcb(xc, blk), dcb_ops.dcb_plain(xc, blk))


# ------------------------------------------------------ grad_reduce

@pytest.mark.parametrize("rows", [1, 2, 9, 128, 1023, dg.RED_CHUNK + 3])
def test_grad_reduce_order_matches_the_sum(rows):
    """The kernel's fixed partition (runs of rows per warp, warps in order,
    a second pass over chunks of RED_CHUNK rows) sums what part.sum(0)
    does."""
    rng = np.random.default_rng(rows)
    part = torch.from_numpy(rng.standard_normal((rows, 18 * 24)
                                                ).astype(np.float32))
    got = dg.grad_reduce_order(part)
    ref = part.double().sum(0)
    assert float((got.double() - ref).abs().max()) \
        <= F32_TOL * float(ref.abs().max())
    assert torch.equal(got, dg.grad_reduce_order(part.clone()))
