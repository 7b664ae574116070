"""The host side of the int8 conv's routes (``ops/qconv.py``,
``csrc/qconv.cu``), on the CPU: the 1x1 route's weight packing against the
canonical K-major layout and back, its route and tile plan at every int8
site shape of the tiny and full profiles (each output element owned once,
shared memory within the limit), the tiled route emulated in torch through
the packed slots and the quantized rows exactly as the kernel reads them
(int64 sums) against ``qconv_plain``, and ``Conv``'s cache of the packed
weight."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ssgvc_tpu_torch.config import profile_model_cfgs
from ssgvc_tpu_torch.experiments.qconv_turns import SITES, STRESS
from ssgvc_tpu_torch.layers import blocks as pb
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.ops import qconv as Q
from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CU = (ROOT / "ssgvc_tpu_torch" / "csrc" / "qconv.cu").read_text()


def canonical(r: int, k: int, row_k: int) -> int:
    """Byte of int8 element (r, k) in a canonical K-major tile whose rows
    hold row_k bytes (csrc/hopper.cuh with 16-byte core-matrix rows: LBO
    128, SBO 8 row_k)."""
    return (r // 8) * 8 * row_k + (k // 16) * 128 + (r % 8) * 16 + k % 16


def test_constants_match_the_kernel_source():
    for name, value in (("KC", Q.KC), ("ROWS", Q.ROWS_WG),
                        ("STAGE_COLS", Q.STAGE_COLS),
                        ("MAX_STAGES", Q.MAX_STAGES),
                        ("SMEM_LIMIT", Q.SMEM_LIMIT)):
        m = re.search(rf"constexpr int {name} = (\d+);", CU)
        assert m and int(m.group(1)) == value, name
    # the .cu's smem_1x1 is the same sum (checked against the compiled one
    # on the card by experiments/qconv_turns.py)
    body = re.search(r"constexpr int smem_1x1\(.*?\{\s*return (.*?);", CU,
                     re.S).group(1)
    assert " ".join(body.split()) == (
        "rg * ROWS * kq + ng * stages * bn * KC + rg * ng * ROWS * "
        "stage_row(bn, osz) + 8 * ((o + bn - 1) / bn * bn) + ng * stages * "
        "16")
    assert "return ((bn < STAGE_COLS ? bn : STAGE_COLS) + 8) * osz;" in CU


@pytest.mark.parametrize("o,kp", [(8, 32), (40, 64), (128, 256), (200, 96),
                                  (514, 544), (1024, 1024)])
def test_pack_weight_is_the_canonical_layout_and_unpacks(o, kp):
    rng = np.random.default_rng(o + kp)
    wq = torch.from_numpy(rng.integers(-127, 128, (o, kp)).astype(np.int8))
    packed = Q.pack_weight(wq)
    bn, kq = Q.tile_n(o), Q.padded_kq(kp)
    nt, nc = -(-o // bn), kq // Q.KC
    assert packed.dtype == torch.int8 and packed.dim() == 1
    assert packed.numel() == nt * nc * bn * Q.KC
    n = torch.arange(nt * bn)[:, None]
    k = torch.arange(kq)[None, :]
    slot = (n // bn) * nc + k // Q.KC
    off = slot * bn * Q.KC + canonical(n % bn, k % Q.KC, Q.KC)
    full = torch.zeros((nt * bn, kq), dtype=torch.int8)
    full[:o, :kp] = wq
    assert torch.equal(packed[off.reshape(-1)].reshape(nt * bn, kq), full)
    assert sorted(off.reshape(-1).tolist()) == list(range(packed.numel()))
    assert torch.equal(Q.unpack_weight(packed, o, kp), wq)


def _tiny_sites():
    """Every int8 site (x shape, O, kernel, stride, pads) the tiny
    profile's DMCI and performance / fast / mask_prop P-frames reach on a
    64x64 frame, recorded from their forwards under SSGVC_INT8=1."""
    sites = set()
    real = pb.qconv

    def record(x, wq, s_w, bias, s_x, kernel, stride, pads, out_dtype=None,
               packed=None):
        sites.add((tuple(x.shape), wq.shape[0], kernel, stride,
                   tuple(pads)))
        return real(x, wq, s_w, bias, s_x, kernel, stride, pads, out_dtype,
                    packed=packed)

    rng = np.random.default_rng(0)
    u = lambda *s: torch.from_numpy(rng.uniform(0, 1, s).astype(np.float32))
    pb.qconv = record
    try:
        with torch.no_grad():
            for variant in ("performance", "fast", "mask_prop"):
                dmc_cfg, dmci_cfg = profile_model_cfgs("tiny", variant)
                model = DMC(dmc_cfg, device="cpu").eval()
                dpb = {"frame": u(1, 64, 64, 3),
                       "feature": u(1, 8, 8, dmc_cfg.ch_d) * 0.1}
                for after_i in (True, False):
                    model(u(1, 64, 64, 3), 20, dpb, after_i=after_i,
                          mask=(u(1, 64, 64, 1) > 0.7).float())
            DMCI(dmci_cfg, device="cpu").eval()(u(1, 64, 64, 3), 20)
    finally:
        pb.qconv = real
    return sites


@pytest.fixture(scope="module")
def tiny_sites():
    mp = pytest.MonkeyPatch()
    mp.setenv("SSGVC_INT8", "1")
    mp.delenv("SSGVC_INT8_SCOPE", raising=False)
    try:
        yield _tiny_sites()
    finally:
        mp.undo()


def test_plan_covers_each_output_once_within_shared_memory(tiny_sites):
    full = {(s[0], s[1], s[2], s[3], s[4]) for s in SITES} | set(STRESS)
    assert len(tiny_sites) > 10
    routes = {"1x1": 0, "gemm": 0}
    for shape, o, k, s, pads in sorted(tiny_sites | full):
        for out_size in (2, 4):
            route, plan = Q.route_of(shape, o, k, s, pads, True, out_size)
            routes[route] += 1
            cin = shape[-1]
            is_1x1 = k == 1 and s == 1 and pads == (0, 0, 0, 0) \
                and cin % 16 == 0
            if route == "gemm":
                # every other site, and a 1x1 whose rows do not fit
                assert not is_1x1 or Q.plan_1x1(
                    shape[0] * shape[1] * shape[2], cin, o, out_size) is None
                assert Q.route_of(shape, o, k, s, pads, False,
                                  out_size)[0] == "gemm"
                continue
            assert is_1x1
            m = shape[0] * shape[1] * shape[2]
            rg, ng, bn, kq = plan["rg"], plan["ng"], plan["bn"], plan["kq"]
            bm = plan["bm"]
            assert plan["smem"] == Q.smem_1x1(rg, ng, bn, kq, plan["stages"],
                                              out_size, o) <= Q.SMEM_LIMIT
            assert 2 <= plan["stages"] <= Q.MAX_STAGES
            # the instances csrc/qconv.cu holds
            assert (rg, ng) in ((2, 1), (1, 2), (1, 1)) and bm == 64 * rg
            assert bn == 128 or (rg, ng) == (1, 1)
            assert ng == 1 or plan["n_tiles"] >= 2
            assert kq % Q.KC == 0 and cin <= kq < cin + Q.KC
            # each block owns bm rows; its warpgroup (row group r, N group
            # g) owns rows 64 r .. 64 r + 63 and the N tiles t % ng == g:
            # each output element once
            owner = torch.zeros((plan["blocks"] * bm,
                                 plan["n_tiles"] * bn), dtype=torch.int32)
            for blk in range(plan["blocks"]):
                for wg in range(rg * ng):
                    r0 = blk * bm + 64 * (wg % rg)
                    for t in range(wg // rg, plan["n_tiles"], ng):
                        owner[r0:r0 + 64, t * bn:(t + 1) * bn] += 1
            assert (owner == 1).all()
            assert owner.shape[0] >= m > owner.shape[0] - bm
            assert owner.shape[1] >= o > owner.shape[1] - bn
    assert routes["1x1"] and routes["gemm"]
    # the P-frame's 1x1 sites all take the 1x1 route
    for shape, o, k, s, pads, per_p, _ in SITES:
        if per_p and k == 1:
            assert Q.route_of(shape, o, k, s, pads, True, 2)[0] == "1x1"


def emulate_1x1(x, wq, s_w, bias, s_x, out_dtype):
    """The 1x1 route as the kernel runs it, in torch: each block quantizes
    its rows into a canonical byte buffer (chunk q at byte 16 q), each
    warpgroup (row group r, N group g) takes its N tiles' ring slots from
    the packed weights, each k32 step reads A and B through the wgmma
    descriptors' offsets (LBO 128, SBO 8 KQ and 8 KC), the sums exact in
    int64, then the epilogue in the kernel's order with the per-column
    scale s_x s_w and bias."""
    b, h, w, cin = x.shape
    o, kp = wq.shape
    m = b * h * w
    plan = Q.plan_1x1(m, cin, o, torch.empty((), dtype=out_dtype)
                      .element_size())
    rg, ng, bn, kq = plan["rg"], plan["ng"], plan["bn"], plan["kq"]
    bm = plan["bm"]
    nc, slot = kq // Q.KC, bn * Q.KC
    packed = Q.pack_weight(wq).long()
    xq = torch.clamp(torch.round(x.float().reshape(m, cin) / s_x), -127,
                     127).long()
    op = plan["n_tiles"] * bn
    scale = torch.zeros(op)
    scale[:o] = s_x * s_w                               # fp32, as __fmul_rn
    bias_p = torch.zeros(op)
    bias_p[:o] = bias
    y = torch.empty((m, o), dtype=out_dtype)
    ra, ka = torch.arange(64)[:, None], torch.arange(32)[None, :]
    rb = torch.arange(bn)[:, None]
    q = torch.arange(bm * kq // 16)
    q_row = (q // (8 * (kq // 16))) * 8 + q % 8
    q_k = ((q // 8) % (kq // 16)) * 16
    for blk in range(plan["blocks"]):
        m0 = blk * bm
        a_buf = torch.zeros(bm * kq, dtype=torch.long)
        for j in range(16):
            rows, ks = m0 + q_row, q_k + j
            ok = (rows < m) & (ks < cin)
            a_buf[16 * q + j] = torch.where(
                ok, xq[rows.clamp(max=m - 1), ks.clamp(max=cin - 1)], 0)
        for wg in range(rg * ng):
            r0 = m0 + 64 * (wg % rg)
            a_grp = a_buf[64 * (wg % rg) * kq:]
            for t in range(wg // rg, plan["n_tiles"], ng):
                acc = torch.zeros((64, bn), dtype=torch.long)
                for c in range(nc):
                    s_buf = packed[(t * nc + c) * slot:(t * nc + c + 1)
                                   * slot]
                    for kk in range(Q.KC // 32):
                        a = a_grp[c * 512 + kk * 256 + (ra // 8) * 8 * kq
                                  + (ka // 16) * 128 + (ra % 8) * 16
                                  + ka % 16]
                        bmat = s_buf[kk * 256 + (rb // 8) * 8 * Q.KC
                                     + (ka // 16) * 128 + (rb % 8) * 16
                                     + ka % 16]
                        acc += a @ bmat.T
                assert acc.abs().max() < 2 ** 31       # int32 is exact
                n0 = t * bn
                v = acc.float() * scale[n0:n0 + bn] + bias_p[n0:n0 + bn]
                rows, cols = min(64, m - r0), min(bn, o - n0)
                if rows > 0:
                    y[r0:r0 + rows, n0:n0 + cols] = \
                        v[:rows, :cols].to(out_dtype)
    return y.reshape(b, h, w, o)


@pytest.mark.parametrize("shape,o", [((1, 9, 21, 48), 40),
                                     ((2, 5, 7, 32), 200),
                                     ((1, 3, 11, 16), 8),
                                     ((1, 4, 20, 80), 100),
                                     ((1, 136, 125, 64), 136)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tiled_route_emulated_equals_plain(shape, o, dtype):
    rng = np.random.default_rng(o)
    cin = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dtype)
    w = torch.from_numpy((rng.standard_normal((o, cin, 1, 1))
                          * cin ** -0.5).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(o) * 0.1).astype(
        np.float32))
    wq, s_w = Q.quantize_weight(w)
    s_x = Q.dynamic_scale(x)
    m = shape[0] * shape[1] * shape[2]
    plan = Q.plan_1x1(m, cin, o, x.element_size())
    if shape[2] == 125:                  # enough rows for 128-row tiles
        assert plan["bm"] == 128 and m % 128
    if o > 128:                          # two N groups, or two row groups
        assert plan["ng"] == 2 or plan["rg"] == 2
    for out_dtype in (dtype, torch.float32):
        ref = Q.qconv_plain(x, wq, s_w, bias, s_x, 1, 1, (0, 0, 0, 0),
                            out_dtype)
        assert torch.equal(emulate_1x1(x, wq, s_w, bias, s_x, out_dtype),
                           ref)


def test_conv_cache_packs_only_when_the_weight_changes(monkeypatch):
    monkeypatch.setenv("SSGVC_INT8", "1")
    calls = []
    real = pb.pack_weight

    def counting(wq):
        calls.append(wq.shape)
        return real(wq)

    monkeypatch.setattr(pb, "pack_weight", counting)
    conv = pb.Conv(16, 24, 1, device="cpu")
    with torch.no_grad():
        conv.weight.normal_(generator=torch.Generator().manual_seed(0))
    x = torch.randn((1, 4, 4, 16), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        conv(x)
        conv(x)
    first = conv.int8_packed()
    assert calls == [(24, 32)]
    assert torch.equal(first, Q.pack_weight(conv.int8_weight()[0]))
    assert conv.int8_packed() is first and len(calls) == 1
    with torch.no_grad():
        conv.weight.mul_(2.0)
        conv.weight[0, 0, 0, 0] = 5.0
        conv(x)
    assert len(calls) == 2
    assert torch.equal(conv.int8_packed(),
                       Q.pack_weight(Q.quantize_weight(conv.weight)[0]))
    assert not torch.equal(conv.int8_packed(), first)
    # a 3x3 has no packed weight
    conv3 = pb.Conv(16, 8, 3, padding=1, device="cpu")
    with torch.no_grad():
        conv3(x)
    assert conv3.int8_packed() is None and len(calls) == 2
