"""The port's real coder against the JAX package's, on the CPU: the host
rANS library, the CDF tables and index builders, the container, the
``VideoCodec`` / ``CodingSession`` round trips, ``evaluate_gop_coded``,
``rd_sweep`` and the Bjontegaard deltas.

What is exact and what is not:
  * rANS streams, quantized pmfs, the y tables (all three profiles) and the
    container are byte for byte the JAX package's, and each package decodes
    the other's streams and files.
  * The z tables are built by the same code; given the same CDF values they
    are identical (checked by feeding the port's builder JAX's CDF). The
    port evaluates the CDF with torch's sigmoid / softplus / tanh, which
    differ from XLA's CPU versions by an fp32 ulp or two (1.8e-7 to 2.4e-7
    on the CDF, by XLA's vector ISA: experiments/f4_z_tables.py), and
    pmf_to_quantized_cdf rounds p * 2^16: measured on the 72x16 table of
    test_z_tables_from_the_ports_cdf, 61 to 67 of 1152 rows differ, by at
    most 2 in one frequency under every setting measured, with the same
    support (lengths and offsets) in every row. Up to 7 bins of one row lie
    within that CDF difference of a rounding boundary, so other ulps can
    move a row by more: the test bounds each row by its own count of such
    bins.
  * The scale-index builders agree on 200k random fp32 scales per profile
    (torch's and XLA's fp32 log differ by an ulp on ~8% of inputs, which
    moves an index only for a scale within an ulp of a table level).
  * The port's own encoder -> decoder round trips are bit-exact
    (np.testing.assert_array_equal).
  * Against the JAX VideoCodec on the same weights and frames (tiny widths,
    64x64, I + 3 P): encoder-side reconstructions within atol 1e-3 (fp32 in
    another summation order, ~1e-6 measured) and stream lengths within 2%;
    evaluate_gop_coded's bpp within 2% and PSNR within 0.1 dB; the BD
    metrics at rtol 1e-9 (the same float64 numpy code).
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssgvc_tpu.coding import bitstream as jbs
from ssgvc_tpu.coding import cdf as jcdf
from ssgvc_tpu.coding import rans as jrans
from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
from ssgvc_tpu.config import DMCIConfig as JaxDMCIConfig
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu.models.dmci import DMCI as JaxDMCI
from ssgvc_tpu.training import evaluate as jev
from ssgvc_tpu_torch.coding import bitstream as tbs
from ssgvc_tpu_torch.coding import cdf as tcdf
from ssgvc_tpu_torch.coding import rans as trans
from ssgvc_tpu_torch.coding.codec import VideoCodec
from ssgvc_tpu_torch.coding.session import CodingSession
from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.models.entropy import BitEstimator
from ssgvc_tpu_torch.training import evaluate as tev
from ssgvc_tpu_torch.utils.weights import load_flax_params
from chip_smoke import DMC_HEADS, DMCI_HEADS
from torch_port_helpers import DMCI_TINY, TINY, drawn_params

HW = 64

# ---------------------------------------------------------------- rANS ----


def _gaussian_rows(sigmas, half=8):
    """Zero-mean Gaussian rows quantized by ``pmf_to_quantized_cdf`` of both
    packages (which must agree), as tests/test_rans.py builds them."""
    import math

    rows, lengths, offsets = [], [], []
    for s in sigmas:
        xs = np.arange(-half, half + 1, dtype=np.float64)
        cdf = lambda v: 0.5 * (1 + np.vectorize(math.erf)(
            v / (s * math.sqrt(2))))
        pmf = (cdf(xs + 0.5) - cdf(xs - 0.5)).astype(np.float32)
        full = np.concatenate([pmf, [2 * cdf(xs[0] - 0.5)]]).astype(
            np.float32)
        q = trans.pmf_to_quantized_cdf(full, 16)
        np.testing.assert_array_equal(q, jrans.pmf_to_quantized_cdf(full, 16))
        row = np.zeros(2 * half + 3, np.int32)
        row[:len(q)] = q
        rows.append(row)
        lengths.append(len(q))
        offsets.append(-half)
    return (np.stack(rows), np.asarray(lengths, np.int32),
            np.asarray(offsets, np.int32))


def _rans_case(name):
    """(tables, encode(coder), decode(coder) -> symbols, expected,
    two_streams) for each case of tests/test_rans.py."""
    rng = np.random.default_rng(7)
    if name == "simple":
        tables = _gaussian_rows([0.5, 1.0, 4.0])
        idx = rng.integers(0, 3, 5000).astype(np.int32)
        sym = np.clip(np.round(rng.normal(0, 2, 5000)), -8, 8).astype(
            np.int16)
        return (tables, lambda ec, g: ec.encode_with_indexes(sym, idx, g),
                lambda ec, g: ec.decode_y(idx, g), sym, False)
    if name == "escapes":
        tables = _gaussian_rows([1.0], half=4)
        sym = np.array([-100, -5, -4, 0, 4, 5, 77, 1000, -30000], np.int16)
        idx = np.zeros(len(sym), np.int32)
        return (tables, lambda ec, g: ec.encode_with_indexes(sym, idx, g),
                lambda ec, g: ec.decode_y(idx, g), sym, False)
    if name == "fused_y":
        tables = _gaussian_rows([0.5, 1.0, 2.0, 4.0])
        idx = rng.integers(0, 4, 1000).astype(np.int16)
        sym = np.clip(np.round(rng.normal(0, 3, 1000)), -127, 127).astype(
            np.int16)
        packed = ((sym << 8) + idx).astype(np.int16)
        return (tables, lambda ec, g: ec.encode_y(packed, g),
                lambda ec, g: ec.decode_y(idx.astype(np.int32), g), sym,
                False)
    if name == "z_offsets":
        tables = _gaussian_rows([0.4 + 0.3 * i for i in range(6)], half=6)
        z = np.clip(np.round(rng.normal(0, 3, 48)), -128, 127).astype(
            np.int8)
        return (tables,
                lambda ec, g: ec.encode_z(z, g, start_offset=2,
                                          per_channel_size=16),
                lambda ec, g: ec.decode_z(len(z), g, start_offset=2,
                                          per_channel_size=16), z, False)
    assert name == "two_streams"
    tables = _gaussian_rows([1.0, 2.0])
    idx = rng.integers(0, 2, 999).astype(np.int32)
    sym = np.clip(np.round(rng.normal(0, 2, 999)), -8, 8).astype(np.int16)
    return (tables, lambda ec, g: ec.encode_with_indexes(sym, idx, g),
            lambda ec, g: ec.decode_y(idx, g), sym, True)


@pytest.mark.parametrize("case", ["simple", "escapes", "fused_y",
                                  "z_offsets", "two_streams"])
def test_rans_streams_match_jax(case):
    tables, encode, decode, expected, two = _rans_case(case)
    streams, coders = {}, {}
    for pkg, mod in (("jax", jrans), ("port", trans)):
        ec = mod.EntropyCoder()
        g = ec.add_cdf(*tables)
        ec.set_use_two_entropy_coders(two)
        ec.reset()
        encode(ec, g)
        ec.flush()
        streams[pkg], coders[pkg] = ec.get_encoded_stream(), (ec, g)
    assert len(streams["port"]) > 0
    assert streams["port"] == streams["jax"]
    # each package decodes the other's stream
    for pkg, other in (("jax", "port"), ("port", "jax")):
        ec, g = coders[pkg]
        ec.set_stream(streams[other])
        decode(ec, g)
        np.testing.assert_array_equal(ec.get_decoded_tensor(),
                                      expected.astype(np.int32))


def test_pmf_to_quantized_cdf_matches_jax():
    rng = np.random.default_rng(1)
    for n in (1, 2, 5, 17, 35, 131):
        for _ in range(20):
            pmf = rng.dirichlet(np.full(n, 0.3)).astype(np.float32)
            pmf[rng.uniform(size=n) < 0.2] = 0.0
            np.testing.assert_array_equal(
                trans.pmf_to_quantized_cdf(pmf, 16),
                jrans.pmf_to_quantized_cdf(pmf, 16))


# ----------------------------------------------------------- CDF tables ----

Y_PROFILES = {None: dict(scan_range=64),
              "gaussian": dict(**tcdf.REFRACTOR_PROFILES["gaussian"],
                               scan_range=50, distribution="gaussian"),
              "laplace": dict(**tcdf.REFRACTOR_PROFILES["laplace"],
                              scan_range=50, distribution="laplace")}


@pytest.mark.parametrize("profile", [None, "gaussian", "laplace"])
def test_y_tables_match_jax(profile):
    assert tcdf.REFRACTOR_PROFILES == jcdf.REFRACTOR_PROFILES
    ref = jcdf.build_y_cdf_tables(**Y_PROFILES[profile])
    out = tcdf.build_y_cdf_tables(**Y_PROFILES[profile])
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def _bit_estimator(qp_num=72, channel=16, seed=16):
    """A JAX BitEstimator's params, perturbed, and the port's module
    holding them."""
    import jax

    from ssgvc_tpu.models.entropy import BitEstimator as JaxBitEstimator

    jbe = JaxBitEstimator(qp_num, channel)
    params = jbe.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 1, channel)),
                      jnp.int32(0))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.5 * rng.standard_normal(a.shape).astype(
            np.float32), params)
    port = load_flax_params(BitEstimator(qp_num, channel, device="cpu"),
                            params)
    return jbe, params, port


def test_z_tables_construction_matches_jax(monkeypatch):
    """Given JAX's CDF values, the port's table builder gives JAX's
    tables exactly."""
    jbe, params, port = _bit_estimator()

    class JaxCdf:
        def __init__(self, qp_num, channel, device):
            pass

        def load_state_dict(self, sd):
            pass

        def get_cdf(self, x, index):
            out = jbe.apply({"params": params}, jnp.asarray(x.numpy()),
                            jnp.asarray(index.numpy()), method=jbe.get_cdf)
            return torch.from_numpy(np.array(out))

    monkeypatch.setattr(tcdf, "BitEstimator", JaxCdf)
    out = tcdf.build_z_cdf_tables(port)
    ref = jcdf.build_z_cdf_tables(params, 72, 16)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def _scaled_rows(cdf_lo, cdf_hi, lengths, offsets, scan_range=16):
    """Each table row's pmf and tail as build_z_cdf_tables quantizes them,
    times 2^16 over the row's total (float64): [row][bin]."""
    qp, _, ch = cdf_lo.shape
    pmf_all = np.clip(cdf_hi - cdf_lo, 0.0, 1.0)
    rows = []
    for r in range(qp * ch):
        q, c = divmod(r, ch)
        lo, n = -int(offsets[r]), int(lengths[r]) - 2
        seg = pmf_all[q, scan_range - lo:scan_range - lo + n, c]
        full = np.concatenate([seg, [max(1.0 - seg.sum(), 0.0)]]).astype(
            np.float32).astype(np.float64)
        rows.append(full / max(full.sum(), 1e-300) * 65536)
    return rows


def test_z_tables_from_the_ports_cdf():
    """The port's z tables from its own CDF against JAX's from XLA's. The
    two CDFs differ by an fp32 ulp or two, by host (XLA's CPU code for
    tanh / softplus / sigmoid: experiments/f4_z_tables.py), and each bin
    whose p 2^16 lies within that difference of a rounding boundary may
    round the other way, the row's largest bin taking up the sum of those
    steps. So: the CDFs within 4 ulps of 1.0; lengths and offsets equal;
    at most 10% of the rows differ; and in every row the largest frequency
    difference at most the number of the row's bins within the measured
    scaled difference of a rounding boundary (a row with none is
    identical)."""
    jbe, params, port = _bit_estimator()
    ref = jcdf.build_z_cdf_tables(params, 72, 16)
    out = tcdf.build_z_cdf_tables(port)
    same = (np.array_equal(out.lengths, ref.lengths),
            np.array_equal(out.offsets, ref.offsets))
    assert out.cdfs.shape == ref.cdfs.shape, (out.cdfs.shape, ref.cdfs.shape)
    freq_diff = np.abs(np.diff(out.cdfs.astype(np.int64), axis=1)
                       - np.diff(ref.cdfs.astype(np.int64), axis=1))
    rows = int((out.cdfs != ref.cdfs).any(axis=1).sum())
    seen = (f"rows {rows} of {len(out.cdfs)}, max freq diff "
            f"{int(freq_diff.max())}, lengths / offsets equal {same}")
    assert all(same), seen
    assert rows <= 0.1 * len(out.cdfs), seen

    # both CDFs where build_z_cdf_tables evaluates them, as it does
    ints = np.arange(-16, 17)
    qp, ch = 72, 16

    def jax_at(g):
        x = jnp.broadcast_to(jnp.asarray(g, jnp.float32)[None, None, :, None],
                             (qp, 1, len(g), ch))
        return np.asarray(jbe.apply({"params": params}, x,
                                    jnp.arange(qp, dtype=jnp.int32),
                                    method=jbe.get_cdf))[:, 0]

    def port_at(g):
        x = torch.from_numpy(np.asarray(g, np.float32))[None, None, :, None]
        with torch.no_grad():
            return port.get_cdf(x.expand(qp, 1, len(g), ch),
                                torch.arange(qp)).numpy()[:, 0]

    lo_j, hi_j = jax_at(ints - 0.5), jax_at(ints + 0.5)
    lo_t, hi_t = port_at(ints - 0.5), port_at(ints + 0.5)
    cdf_diff = max(np.abs(lo_j - lo_t).max(), np.abs(hi_j - hi_t).max())
    # measured 1.8e-7 to 2.4e-7 (1.5 to 2 ulps) under every setting
    assert cdf_diff <= 4 * np.spacing(np.float32(1.0)), (cdf_diff, seen)
    sj = _scaled_rows(lo_j, hi_j, ref.lengths, ref.offsets)
    st = _scaled_rows(lo_t, hi_t, ref.lengths, ref.offsets)
    delta = max(np.abs(a - b).max() for a, b in zip(sj, st))
    for r, s in enumerate(sj):
        near = int((np.abs(s - np.floor(s) - 0.5) <= delta).sum())
        assert freq_diff[r].max() <= near, (r, near, delta, seen)


@pytest.mark.parametrize("profile", [None, "gaussian", "laplace"])
def test_index_builders_match_jax(profile):
    kw = ({} if profile is None else
          {k: v for k, v in tcdf.REFRACTOR_PROFILES[profile].items()})
    rng = np.random.default_rng(2)
    scales = np.exp(rng.uniform(np.log(0.005), np.log(100.0), 200_000)
                    ).astype(np.float32)
    symbols = rng.normal(0, 60, scales.shape).astype(np.float32)
    np.testing.assert_array_equal(
        tcdf.build_indexes_decoder(torch.from_numpy(scales), **kw).numpy(),
        np.asarray(jcdf.build_indexes_decoder(jnp.asarray(scales), **kw)))
    np.testing.assert_array_equal(
        tcdf.build_indexes_encoder(torch.from_numpy(symbols),
                                   torch.from_numpy(scales), **kw).numpy(),
        np.asarray(jcdf.build_indexes_encoder(jnp.asarray(symbols),
                                              jnp.asarray(scales), **kw)))


def test_index_builders_take_non_finite_values_as_jax_does():
    """A NaN scale (a DPB overflowed past fp32) is row 0 in both packages,
    a table row, and never a read outside the table; +-inf scales and
    symbols clamp to the ends."""
    scales = np.array([np.nan, np.inf, -np.inf, 0.5, 100.0, np.nan],
                      np.float32)
    symbols = np.array([np.nan, np.inf, -np.inf, 3.4, -200.0, 7.0],
                       np.float32)
    idx = tcdf.build_indexes_decoder(torch.from_numpy(scales)).numpy()
    np.testing.assert_array_equal(
        idx, np.asarray(jcdf.build_indexes_decoder(jnp.asarray(scales))))
    assert idx.min() >= 0 and idx.max() < 128 and idx[0] == idx[-1] == 0
    np.testing.assert_array_equal(
        tcdf.build_indexes_encoder(torch.from_numpy(symbols),
                                   torch.from_numpy(scales)).numpy(),
        np.asarray(jcdf.build_indexes_encoder(jnp.asarray(symbols),
                                              jnp.asarray(scales))))


# ------------------------------------------------------------ container ----


def _write_units(mod):
    buf = io.BytesIO()
    w = mod.BitstreamWriter(buf)
    w.write_frame(True, 1088, 1920, 21, b"i" * 300)
    w.write_frame(False, 1088, 1920, 29, b"p1" * 40000)
    w.write_frame(False, 64, 64, 25, b"", ec_part=1)
    w.write_frame(False, 1088, 1920, 255, b"p3")
    return buf.getvalue()


def test_container_bytes_match_jax():
    data = _write_units(tbs)
    assert data == _write_units(jbs)
    for reader_mod in (jbs, tbs):   # JAX's reader reads the port's file
        r = reader_mod.BitstreamReader(io.BytesIO(data))
        units = [r.read_frame() for _ in range(5)]
        assert units[-1] is None
        assert [u["type"] for u in units[:4]] == ["i", "p", "p", "p"]
        assert [u["qp"] for u in units[:4]] == [21, 29, 25, 255]
        assert units[1]["payload"] == b"p1" * 40000
        assert (units[2]["sps"].height, units[2]["sps"].ec_part) == (64, 1)


def test_adaptive_uint_round_trip():
    buf = io.BytesIO()
    values = [0, 1, 253, 254, 255, 65535, 65536, 10 ** 9]
    for v in values:
        tbs.write_uint_adaptive(buf, v)
    buf.seek(0)
    assert [tbs.read_uint_adaptive(buf) for _ in values] == values


def test_sps_helper_id_reuse():
    h = tbs.SPSHelper()
    id1, new1 = h.get_sps_id(1080, 1920)
    id2, new2 = h.get_sps_id(1080, 1920)
    id3, new3 = h.get_sps_id(720, 1280)
    assert new1 and not new2 and new3
    assert id1 == id2 != id3


# ------------------------------------------------------ codec round trips --

_models = {}


def _models_for(variant):
    """The port's tiny DMCI and DMC with drawn weights, and their flax
    trees, cached for the module."""
    if variant not in _models:
        dmci = DMCI(DMCIConfig(**DMCI_TINY), device="cpu").eval()
        dmc = DMC(DMCConfig.variant(variant, **TINY), device="cpu").eval()
        _models[variant] = (dmci, drawn_params(dmci, 0, DMCI_HEADS), dmc,
                            drawn_params(dmc, 1, DMC_HEADS))
    return _models[variant]


def _codec(variant="performance", **kw):
    dmci, _, dmc, _ = _models_for(variant)
    return VideoCodec(dmci, dmc, **kw)


def _frames(seed, n=4):
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0, 1, (n, HW, HW, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (n, HW, HW, 1)) > 0.6).astype(np.float32)
    return frames, masks


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))[None]


def _gop_round_trip(codec, seed, n_p=3, qps=(20, 28, 24, 32), use_mask=True):
    """I + n_p P-frames encoded, then decoded from the streams alone;
    returns the stream lengths after asserting bit-exact frames, DPBs and
    (mask_prop) mask chains."""
    frames, masks = _frames(seed, n_p + 1)
    propagated = codec.dmc.cfg.mask_source == "propagated"
    enc_i = codec.dmci_compress(_t(frames[0]), qps[0])
    dec_i = codec.dmci_decompress(enc_i["bit_stream"], HW, HW, qps[0])
    np.testing.assert_array_equal(dec_i["x_hat"].numpy(),
                                  enc_i["x_hat"].numpy())
    assert torch.isfinite(enc_i["x_hat"]).all()
    feat0 = torch.zeros((1, HW // 8, HW // 8, TINY["ch_d"]))
    dpb_e = {"frame": enc_i["x_hat"], "feature": feat0}
    streams, outs = [enc_i["bit_stream"]], []
    m_e = _t(masks[1]) if use_mask else None
    for t in range(1, n_p + 1):
        out = codec.dmc_compress(_t(frames[t]), qps[t], dpb_e,
                                 after_i=(t == 1), mask=m_e)
        streams.append(out["bit_stream"])
        outs.append(out)
        dpb_e = out["dpb"]
        if propagated:
            m_e = out["mask_out"]
        elif use_mask:
            m_e = _t(masks[min(t + 1, n_p)])
    dpb_d = {"frame": dec_i["x_hat"], "feature": feat0}
    m_d = _t(masks[1]) if propagated else None
    for t in range(1, n_p + 1):
        dec = codec.dmc_decompress(streams[t], HW, HW, qps[t], dpb_d,
                                   after_i=(t == 1), mask=m_d)
        enc = outs[t - 1]
        assert dec["x_hat"].shape == (1, HW, HW, 3)
        assert torch.isfinite(enc["x_hat"]).all()
        np.testing.assert_array_equal(dec["x_hat"].numpy(),
                                      enc["x_hat"].numpy())
        for k in ("frame", "feature"):
            np.testing.assert_array_equal(dec["dpb"][k].numpy(),
                                          enc["dpb"][k].numpy())
        if propagated:
            np.testing.assert_array_equal(dec["mask_out"].numpy(),
                                          enc["mask_out"].numpy())
            m_d = dec["mask_out"]
        dpb_d = dec["dpb"]
    return [len(s) for s in streams]


def test_dmci_round_trip():
    codec = _codec()
    x = _t(_frames(1)[0][0])
    enc = codec.dmci_compress(x, 30)
    assert len(enc["bit_stream"]) > 0
    dec = codec.dmci_decompress(enc["bit_stream"], HW, HW, 30)
    np.testing.assert_array_equal(dec["x_hat"].numpy(), enc["x_hat"].numpy())


def test_dmc_gop_round_trip():
    lengths = _gop_round_trip(_codec(), seed=2)
    assert all(n > 0 for n in lengths)


def test_packed_dmc_round_trip():
    codec = _codec(packed_dmc=True)
    assert codec.dmc.cfg.packed_io
    frames, masks = _frames(7, 2)
    enc_i = codec.dmci_compress(_t(frames[0]), 24)
    out = codec.dmc_compress(_t(frames[1]), 24,
                             {"frame": enc_i["x_hat"],
                              "feature": torch.zeros(1, 8, 8, 16)},
                             after_i=True, mask=_t(masks[1]))
    assert out["x_hat"].shape == (1, HW, HW, 3)        # raw API out
    assert out["dpb"]["frame"].shape[-1] == 192        # packed DPB carry
    _gop_round_trip(codec, seed=7)


def test_two_coder_round_trip():
    lengths = _gop_round_trip(_codec(ec_part=1), seed=9, n_p=1)
    assert all(n > 4 for n in lengths)


def test_skip_threshold_round_trip():
    plain = _gop_round_trip(_codec(), seed=11, n_p=2, qps=(40, 40, 40))
    skip = _gop_round_trip(_codec(skip_thres=0.5), seed=11, n_p=2,
                           qps=(40, 40, 40))
    assert skip[0] == plain[0]            # no skip on the I-frame
    assert sum(skip[1:]) < sum(plain[1:])


@pytest.mark.parametrize("profile", ["gaussian", "laplace"])
def test_coder_profile_round_trip(profile):
    codec = _codec(coder_profile=profile)
    assert codec.scale_levels == 256 and codec.scale_max == 64.0
    _gop_round_trip(codec, seed=17, n_p=1, qps=(2, 40))


@pytest.mark.parametrize("packed", [False, True])
def test_mask_prop_round_trip(packed):
    codec = _codec("mask_prop", packed_dmc=packed)
    _gop_round_trip(codec, seed=13, n_p=3, qps=(30, 30, 30, 30))


def test_coding_session_file_round_trip(tmp_path):
    codec = _codec("mask_prop")
    frames, masks = _frames(5, 5)
    session = CodingSession(codec, gop_size=4)
    path = tmp_path / "seq.bin"
    with open(path, "wb") as f:
        stats = session.encode_sequence(f, frames, qp=25, masks=masks)
    assert stats["frame_types"] == ["I", "P", "P", "P", "I"]
    assert all(b > 0 for b in stats["frame_bits"])
    assert len(stats["masks"]) == 3
    with open(path, "rb") as f:
        decoded, chain = session.decode_sequence(f, masks=masks,
                                                 return_masks=True)
    assert len(decoded) == 5 and len(chain) == 3
    for rec, enc_rec in zip(decoded, stats["recons"]):
        np.testing.assert_array_equal(rec, enc_rec)
    for dm, em in zip(chain, stats["masks"]):
        np.testing.assert_array_equal(dm, em)
    # the JAX package's reader reads the port's container
    with open(path, "rb") as f:
        r = jbs.BitstreamReader(f)
        units = [r.read_frame() for _ in range(5)]
    assert [u["type"] for u in units] == ["i", "p", "p", "p", "i"]
    assert [len(u["payload"]) * 8 for u in units] == stats["frame_bits"]


# ---------------------------------------------------- against JAX's codec --


def _jax_codec(variant="performance"):
    from ssgvc_tpu.coding.codec import VideoCodec as JaxVideoCodec

    _, pi, _, pp = _models_for(variant)
    return JaxVideoCodec(JaxDMCI(JaxDMCIConfig(**DMCI_TINY)), pi,
                         JaxDMC(JaxDMCConfig.variant(variant, **TINY)), pp)


def test_codec_matches_jax():
    jc, tc = _jax_codec(), _codec()
    frames, masks = _frames(3)
    je = jc.dmci_compress(jnp.asarray(frames[0])[None], 30)
    te = tc.dmci_compress(_t(frames[0]), 30)
    pairs = [(je, te)]
    jd = {"frame": je["x_hat"], "feature": jnp.zeros((1, 8, 8, 16))}
    td = {"frame": te["x_hat"], "feature": torch.zeros(1, 8, 8, 16)}
    for t in (1, 2, 3):
        jo = jc.dmc_compress(jnp.asarray(frames[t])[None], 30, jd,
                             after_i=(t == 1),
                             mask=jnp.asarray(masks[t])[None])
        to = tc.dmc_compress(_t(frames[t]), 30, td, after_i=(t == 1),
                             mask=_t(masks[t]))
        pairs.append((jo, to))
        jd, td = jo["dpb"], to["dpb"]
    for jo, to in pairs:
        np.testing.assert_allclose(to["x_hat"].numpy(),
                                   np.asarray(jo["x_hat"]), atol=1e-3)
        nj, nt = len(jo["bit_stream"]), len(to["bit_stream"])
        assert abs(nt - nj) <= 0.02 * nj, (nt, nj)


def test_evaluate_gop_coded_matches_jax():
    frames, masks = _frames(4)
    index_map, qp_shift = (0, 1, 0, 2), (0, 8, 4)
    ref = jev.evaluate_gop_coded(_jax_codec(), frames, masks, 28, index_map,
                                 qp_shift)
    out = tev.evaluate_gop_coded(_codec(), frames, masks, 28, index_map,
                                 qp_shift)
    assert [r["frame_type"] for r in out] == ["I", "P", "P", "P"]
    for o, r in zip(out, ref):
        assert o.keys() == r.keys()
        assert abs(o["bpp"] - r["bpp"]) <= 0.02 * r["bpp"]
        for k in ("psnr", "roi_psnr"):
            assert abs(o[k] - r[k]) <= 0.1, (k, o[k], r[k])
        assert o["msssim"] is None and r["msssim"] is None   # < 88 px


def test_rd_sweep_matches_jax():
    def fake_eval(qp):
        return [{"frame_type": t, "bpp": 0.01 * qp + i, "psnr": 30 + i * qp,
                 "roi_psnr": 31 - i, "msssim": None if i == 2 else 0.9}
                for i, t in enumerate(["I", "P", "P"])]

    assert tev.rd_sweep(fake_eval, [10, 20, 37]) == jev.rd_sweep(
        fake_eval, [10, 20, 37])


@pytest.mark.parametrize("n", [4, 3, 2])
def test_bd_metrics_match_jax(n):
    rate_a = [0.05, 0.1, 0.2, 0.4][:n]
    psnr_a = [30.1, 32.4, 34.2, 36.0][:n]
    rate_t = [0.045, 0.088, 0.19, 0.37][:n]
    psnr_t = [30.4, 32.6, 34.9, 36.3][:n]
    for name in ("bd_rate", "bd_psnr"):
        out = getattr(tev, name)(rate_a, psnr_a, rate_t, psnr_t)
        ref = getattr(jev, name)(rate_a, psnr_a, rate_t, psnr_t)
        np.testing.assert_allclose(out, ref, rtol=1e-9, err_msg=name)
    # curves that do not overlap give nan in both
    assert np.isnan(tev.bd_rate([1, 2], [30, 31], [1, 2], [40, 41]))
    assert np.isnan(tev.bd_psnr([1, 2], [30, 31], [3, 4], [40, 41]))
