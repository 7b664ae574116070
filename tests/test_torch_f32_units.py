"""The SIMT fp32 DepthConvBlock kernel's work plan (``csrc/dcb_f32.cu``) on
the CPU: the units ``ops.dcb.f32_plan`` / ``f32_units`` lay out (whole
small images, or 8x8 tiles with a one-pixel halo), its constants, K split
and shared-memory plan against the CUDA source, the weight groups its bulk
copies bring in, and an emulation of the kernel's data flow through those
tables (window gather, masked h, the depthwise through each output's tap
mask, the K-split products, the chain in shared memory) against the plain
block.

Tolerance: the emulation against ``dcb_plain`` at 1e-5 of max |ref| (fp32
sums in another order), the fp32 kernels' measure.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ssgvc_tpu_torch.ops import dcb as dcb_ops
from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
from torch_port_helpers import one_torch_thread  # noqa: F401

F32_TOL = 1e-5
SOURCE = (Path(dcb_ops.__file__).resolve().parent.parent / "csrc"
          / "dcb_f32.cu").read_text()
# the RD recipe's shapes (B = 8), a ragged batch, and frames cut into tiles
SHAPES = [(8, 1, 1), (8, 2, 2), (8, 4, 4), (8, 8, 8), (3, 5, 7),
          (1, 40, 52), (1, 136, 240)]
WIDTHS = tuple(range(8, 65, 8))


def cu_int(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


def pixel(px, h, w):
    """(image, row, column) of a pixel of the (B H W) stack."""
    return px // (h * w), px % (h * w) // w, px % w


@pytest.mark.parametrize("shape", SHAPES)
def test_every_output_pixel_is_covered_exactly_once(shape):
    b, h, w = shape
    res = dcb_ops.f32_units(b, h, w, 32)
    pl = res["plan"]
    assert len(res["units"]) == pl.units
    seen = np.zeros(b * h * w, np.int64)
    for unit in res["units"]:
        assert len(unit) == pl.cs
        for cta in unit:
            assert len(cta["slots"]) == pl.q <= dcb_ops.F32_LDQ
            assert len(cta["outputs"]) == pl.p <= dcb_ops.F32_PMAX
            assert pl.q % dcb_ops.F32_RP == 0 and pl.p % dcb_ops.F32_RP == 0
            for _, px, _ in cta["outputs"]:
                if px >= 0:
                    seen[px] += 1
    assert (seen == 1).all()
    # whole images wherever one fits a unit (every RD shape, the ragged
    # batch), over a cluster of up to 4 CTAs of at least 16 pixels each;
    # the frames are cut into tiles, one CTA each
    assert pl.whole == (h * w <= dcb_ops.F32_PMAX)
    if pl.whole:
        g = min(dcb_ops.F32_PMAX // (h * w), b)
        assert pl.g == g
        assert pl.cs == (4 if g * h * w >= 64 else 2 if g * h * w >= 32
                         else 1)
        assert pl.cs == 1 or pl.p >= dcb_ops.F32_PCTA
    else:
        assert pl.cs == 1 and (pl.th, pl.tw) == dcb_ops.F32_TILE


@pytest.mark.parametrize("shape", SHAPES)
def test_no_window_reaches_across_images(shape):
    """Every window slot holds a pixel of its own image (or nothing), and
    every tap an output reads is its own image's neighbour, or a zero where
    the neighbour lies outside the image."""
    b, h, w = shape
    res = dcb_ops.f32_units(b, h, w, 64)
    pl = res["plan"]
    for u, unit in enumerate(res["units"]):
        images = (set(range(u * pl.g, min(b, (u + 1) * pl.g))) if pl.whole
                  else {u // pl.tiles})
        for cta in unit:
            for px in cta["slots"]:
                assert px < 0 or pixel(px, h, w)[0] in images
            for sl, px, nbrs in cta["outputs"]:
                if px < 0:
                    continue
                assert cta["slots"][sl] == px
                img, r, col = pixel(px, h, w)
                for t, e in enumerate(nbrs):
                    yy, xx = r + t // 3 - 1, col + t % 3 - 1
                    inside = 0 <= yy < h and 0 <= xx < w
                    if e < 0:
                        assert not inside
                        continue
                    # the h of another CTA of the same cluster, or its own
                    assert e >> 8 < pl.cs
                    got = unit[e >> 8]["slots"][e & 255]
                    assert got == ((img * h + yy) * w + xx if inside else -1)


def test_plan_and_constants_match_the_cuda_source():
    assert cu_int("kThreads") == dcb_ops.F32_THREADS
    assert cu_int("kMaxC") == dcb_ops.F32_MAX_CHANNELS
    assert cu_int("PMAX") == dcb_ops.F32_PMAX
    assert cu_int("PCTA") == dcb_ops.F32_PCTA
    assert cu_int("MAX_CS") == dcb_ops.F32_MAX_CS
    assert cu_int("RP") == dcb_ops.F32_RP
    assert cu_int("LDQ") == dcb_ops.F32_LDQ
    assert cu_int("LDP") == dcb_ops.F32_LDP
    assert cu_int("kGroups") == dcb_ops.F32_GROUPS == 5
    m = re.search(r"constexpr int TILE_H = (\d+), TILE_W = (\d+);", SOURCE)
    assert (int(m.group(1)), int(m.group(2))) == dcb_ops.F32_TILE
    th, tw = dcb_ops.F32_TILE
    assert th * tw <= dcb_ops.F32_PMAX
    assert (th + 2) * (tw + 2) <= dcb_ops.F32_LDQ
    assert dcb_ops.F32_LDQ % dcb_ops.F32_RP == 0
    assert dcb_ops.F32_LDP == dcb_ops.F32_PMAX + 4
    # the plan struct's fields, in the order the C entry reports them
    body = re.search(r"struct Plan \{(.*?)\};", SOURCE, re.S).group(1)
    fields = re.findall(r"\b(\w+)[,;]", re.sub(r"//.*", "", body))
    assert [f.lower() for f in fields] == list(dcb_ops.F32Plan._fields)
    assert cu_int("kPlanFields") == len(fields)
    # the SIMT route ends where the 3xTF32 one begins
    assert not dcb_ops.uses_tf32(dcb_ops.F32_MAX_CHANNELS)
    assert dcb_ops.uses_tf32(dcb_ops.F32_MAX_CHANNELS + 8)


def test_shared_memory_plan_fits_at_every_width():
    """At most 227 KiB (the card's 232,448 bytes) at every C from 8 to 64,
    by the .cu's formula, and two thread blocks an SM at C <= 40."""
    def returned(fn):
        m = re.search(rf"constexpr int {fn}\(int C\) \{{\s*return (.*?);",
                      SOURCE, re.S)
        return " ".join(m.group(1).split())
    names = dict(LDQ=dcb_ops.F32_LDQ, LDP=dcb_ops.F32_LDP,
                 PMAX=dcb_ops.F32_PMAX, kGroups=dcb_ops.F32_GROUPS)
    weights = returned("weight_floats")
    for c in WIDTHS:
        cu = eval(returned("smem_bytes"),
                  {"weight_floats": lambda c: eval(weights, {}, {"C": c})},
                  dict(names, C=c))
        got = dcb_ops.f32_smem_bytes(c)
        assert got == cu, c
        assert got <= 227 * 1024 <= dcb_ops.SMEM_LIMIT, c
        if c <= 40:       # 1 KiB of each SM's 228 KiB is reserved a block
            assert 2 * (got + 1024) <= 228 * 1024, c


def test_the_k_split_is_a_function_of_c_alone():
    """The same K split at every shape for one C (so every sum runs in one
    order whatever the batch), dividing both K of the products (C and 2C),
    a power of two within a warp; the .cu's ksplit gives the same."""
    expr = re.search(r"constexpr int ksplit\(int C\) \{\s*return (.*?);",
                     SOURCE, re.S).group(1)
    steps = [(op, int(t), int(v))
             for op, t, v in re.findall(r"C (==|<=) (\d+) \? (\d+)", expr)]
    last = int(re.search(r": (\d+)$", expr.strip()).group(1))
    hit = lambda op, c, t: c == t if op == "==" else c <= t
    to_py = lambda c: next((v for op, t, v in steps if hit(op, c, t)), last)
    for c in WIDTHS:
        ks = {dcb_ops.f32_units(b, h, w, c)["ksplit"]
              for b, h, w in SHAPES[:5]}
        assert ks == {dcb_ops.f32_ksplit(c)} == {to_py(c)}, c
        k = ks.pop()
        assert c % k == 0 and 32 % k == 0 and k & (k - 1) == 0
        # 256 threads over a 64-pixel unit's C x 64 outputs in 8x8 tiles
        # at C = 32 and 64
        if c in (32, 64):
            assert (64 // 8) * (c // 8) * k == dcb_ops.F32_THREADS


def test_weight_groups_partition_the_packed_block():
    """The five groups' spans cover pack_f32's 8 C^2 + 17 C floats once,
    each span 16-byte aligned and a multiple of 16 bytes (the bulk
    copies), and a chain's later blocks stay aligned."""
    for c in WIDTHS:
        total = 8 * c * c + 17 * c
        cover = np.zeros(total, np.int64)
        for group in dcb_ops.f32_groups(c):
            for off, n in group:
                assert off % 4 == 0 and n % 4 == 0 and n > 0
                cover[off:off + n] += 1
        assert (cover == 1).all(), c
        assert total % 4 == 0
    # the packed block's order: W0^T, W3^T, Wf0^T, Wf2^T, taps, biases
    rng = np.random.default_rng(0)
    c = 16
    params = block_params(c, rng)
    flat = dcb_ops.pack_f32(params)
    mats = unpack_f32(flat, c)
    w0, b0, w2, b2, w3, b3, wf0, bf0, wf2, bf2 = params
    assert torch.equal(mats["w0"], w0.reshape(c, c).t())
    assert torch.equal(mats["w3"], w3.reshape(c, c).t())
    assert torch.equal(mats["wf0"], wf0.reshape(4 * c, c).t())
    assert torch.equal(mats["wf2"], wf2.reshape(c, 2 * c).t())
    assert torch.equal(mats["taps"], w2.reshape(c, 9).t())
    for k, v in (("b0", b0), ("b2", b2), ("b3", b3), ("bf0", bf0),
                 ("bf2", bf2)):
        assert torch.equal(mats[k], v)


def test_chain_buffer_plan_in_shared_memory():
    """On whole-image units a chain keeps every output but the last in
    shared memory: no scratch tensor."""
    for n in range(1, 6):
        plan = chain_ops.buffer_plan(n, in_smem=True)
        assert plan[0][0] == "x" and plan[-1][1] == "y"
        assert all(d != "s" and s != "s" for s, d in plan)
        assert all(plan[j][1] == plan[j + 1][0] for j in range(n - 1))
    assert chain_ops.buffer_plan(3) == [("x", "y"), ("y", "s"), ("s", "y")]


# ---- the kernel's data flow, emulated through the unit tables ----

def block_params(c, rng):
    def t(shape, std):
        return torch.tensor(rng.standard_normal(shape) * std,
                            dtype=torch.float32)
    return (t((c, c, 1, 1), c ** -0.5), t((c,), 0.1),
            t((c, 1, 3, 3), 1 / 3), t((c,), 0.1),
            t((c, c, 1, 1), 0.3 * c ** -0.5), t((c,), 0.1),
            t((4 * c, c, 1, 1), c ** -0.5), t((4 * c,), 0.1),
            t((c, 2 * c, 1, 1), 0.3 * (2 * c) ** -0.5), t((c,), 0.1))


def unpack_f32(flat, c):
    """The matrices ([in][out]) and vectors of one pack_f32 block, read at
    the offsets of the kernel's weight groups."""
    g = dcb_ops.f32_groups(c)
    span = lambda gi, k: flat[g[gi][k][0]:g[gi][k][0] + g[gi][k][1]]
    return {"w0": span(0, 0).reshape(c, c), "b0": span(0, 1),
            "taps": span(1, 0).reshape(9, c), "b2": span(1, 1),
            "w3": span(2, 0).reshape(c, c), "b3": span(2, 1),
            "wf0": span(3, 0).reshape(c, 4 * c), "bf0": span(3, 1),
            "wf2": span(4, 0).reshape(2 * c, c), "bf2": span(4, 1)}


def product(a, w, ks):
    """a (pixels, K) @ w (K, N) as the kernel sums it: ks segments of K,
    each in order, added by the butterfly's pairwise tree."""
    kn = a.shape[1] // ks
    parts = [a[:, s * kn:(s + 1) * kn] @ w[s * kn:(s + 1) * kn]
             for s in range(ks)]
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def emulate_block(xwins, unit, pl, m, ks, q, shortcut):
    """One block on one unit: xwins, per CTA of its cluster, (q slots, C)
    -> per CTA y (p outputs, C). Each CTA's h is computed at its own
    slots; the depthwise reads any CTA's through the neighbour table."""
    c = xwins[0].shape[1]
    hs = []
    for xwin, cta in zip(xwins, unit):
        h = dcb_ops.wsilu(product(xwin, m["w0"], ks) + m["b0"])
        valid = (torch.tensor(cta["slots"]) >= 0)[:, None]
        hs.append(torch.where(valid, h, torch.zeros(())))
    ys = []
    for xwin, cta in zip(xwins, unit):
        out_slot = torch.tensor([o[0] for o in cta["outputs"]])
        g = m["b2"].expand(len(out_slot), c).clone()
        for t in range(9):
            nb = [o[2][t] for o in cta["outputs"]]
            hv = torch.stack([hs[e >> 8][e & 255] if e >= 0
                              else torch.zeros(c) for e in nb])
            g = g + m["taps"][t] * hv
        xo = xwin[out_slot]
        u = xo + (product(g, m["w3"], ks) + m["b3"])
        fa = product(u, m["wf0"][:, :2 * c], ks) + m["bf0"][:2 * c]
        fb = product(u, m["wf0"][:, 2 * c:], ks) + m["bf0"][2 * c:]
        f = dcb_ops.wsilu(fa) + dcb_ops.wsilu(fb)
        y = (product(f, m["wf2"], ks) + m["bf2"]) + u
        if shortcut:
            y = y + xo
        if q is not None:
            y = y * q
        ys.append(y)
    return ys


def emulate(x, blocks, q=None, shortcut=False):
    """The kernel's schedule on the CPU: whole-image units run every block
    in their CTAs' windows (the chain in shared memory), tile units run
    block j on every unit through a buffer before block j + 1."""
    b, h, w, c = x.shape
    n = len(blocks)
    res = dcb_ops.f32_units(b, h, w, c)
    pl, ks = res["plan"], res["ksplit"]
    mats = [unpack_f32(dcb_ops.pack_f32(p), c) for p in blocks]
    flat = x.reshape(-1, c)
    gather = lambda src, cta: torch.stack(
        [src[px] if px >= 0 else torch.zeros(c) for px in cta["slots"]])

    def scatter(dst, unit, ys):
        for cta, y in zip(unit, ys):
            for (_, px, _), row in zip(cta["outputs"], y):
                if px >= 0:
                    dst[px] = row

    if pl.whole:
        out = torch.full_like(flat, float("nan"))
        for unit in res["units"]:
            xwins = [gather(flat, cta) for cta in unit]
            for j, m in enumerate(mats):
                # whole units: output p of a CTA is its slot p
                xwins = emulate_block(xwins, unit, pl, m, ks,
                                      q if j == n - 1 else None, shortcut)
            scatter(out, unit, xwins)
    else:
        out = flat
        for j, m in enumerate(mats):
            dst = torch.full_like(flat, float("nan"))
            for unit in res["units"]:
                scatter(dst, unit, emulate_block(
                    [gather(out, cta) for cta in unit], unit, pl, m, ks,
                    q if j == n - 1 else None, shortcut))
            out = dst
    return out.reshape(x.shape)


def max_rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("b,h,w,c,shortcut,with_q", [
    (8, 1, 1, 32, True, False), (8, 2, 2, 8, True, True),
    (8, 4, 4, 16, False, True), (2, 8, 8, 24, True, True),
    (3, 5, 7, 32, False, True), (1, 12, 20, 16, True, True)])
# clusters of 2 (2x2, 5x7) and 4 (4x4, 8x8) CTAs; 12x20 in 8x8 tiles
def test_emulated_block_matches_plain(b, h, w, c, shortcut, with_q):
    rng = np.random.default_rng(b * 100 + c + h)
    x = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=torch.float32)
    q = torch.linspace(0.5, 1.5, c) if with_q else None
    params = block_params(c, rng)
    out = emulate(x, [params], q, shortcut)
    ref = dcb_ops.dcb_plain(x, params, q, shortcut)
    assert torch.isfinite(out).all()
    assert max_rel(out, ref) <= F32_TOL


@pytest.mark.parametrize("b,h,w,c,n", [
    (8, 8, 8, 8, 2), (2, 4, 4, 16, 4), (1, 9, 13, 8, 3), (2, 1, 1, 8, 2)])
def test_emulated_chain_matches_plain(b, h, w, c, n):
    """A chain on whole images (in shared memory) and on tiles (through
    the buffers), q on the last output."""
    rng = np.random.default_rng(n * 10 + c)
    x = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=torch.float32)
    q = torch.linspace(0.5, 1.5, c)
    blocks = [block_params(c, rng) for _ in range(n)]
    out = emulate(x, blocks, q)
    ref = chain_ops.dcb_chain_plain(x, blocks, q)
    assert torch.isfinite(out).all()
    assert max_rel(out, ref) <= F32_TOL
