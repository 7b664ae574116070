"""ctypes bindings of the port's host rANS coder (``csrc/rans.cpp``).

Two interfaces over one library:
  * ``EntropyCoder``: reset / add_cdf / encode_y (fused int16 sym<<8|idx) /
    encode_z (int8 + per-channel rows) / flush / get_encoded_stream /
    set_stream / decode_y / decode_z / get_decoded_tensor /
    set_use_two_entropy_coders;
  * ``RansEncoder.encode_with_indexes`` / ``RansDecoder.decode_batch``:
    separate symbol and index arrays.

The library is built at first use with the host C++ compiler
(``ops/_build.load_host``); a failed build raises, there is no other coder.
Its streams are byte for byte those of the JAX package's coder.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build

_lib = None


def get_lib() -> ctypes.CDLL:
    """The coder's library with its C signatures declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load_host("rans")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    vp, sz, ci = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int

    lib.rans_encoder_new.argtypes = []
    lib.rans_encoder_new.restype = vp
    lib.rans_encoder_free.argtypes = [vp]
    lib.rans_encoder_reset.argtypes = [vp]
    lib.rans_encoder_set_two.argtypes = [vp, ci]
    lib.rans_encoder_add_cdf.argtypes = [vp, i32p, i32p, i32p, ci, ci]
    lib.rans_encoder_add_cdf.restype = ci
    lib.rans_encoder_encode_with_indexes.argtypes = [vp, i16p, i32p, sz, ci]
    lib.rans_encoder_encode_y.argtypes = [vp, i16p, sz, ci]
    lib.rans_encoder_encode_z.argtypes = [vp, i8p, sz, ci, ci, ci]
    lib.rans_encoder_flush.argtypes = [vp]
    lib.rans_encoder_stream_size.argtypes = [vp]
    lib.rans_encoder_stream_size.restype = sz
    lib.rans_encoder_get_stream.argtypes = [vp, u8p]

    lib.rans_decoder_new.argtypes = []
    lib.rans_decoder_new.restype = vp
    lib.rans_decoder_free.argtypes = [vp]
    lib.rans_decoder_set_two.argtypes = [vp, ci]
    lib.rans_decoder_add_cdf.argtypes = [vp, i32p, i32p, i32p, ci, ci]
    lib.rans_decoder_add_cdf.restype = ci
    lib.rans_decoder_set_stream.argtypes = [vp, u8p, sz]
    lib.rans_decoder_decode_batch.argtypes = [vp, i32p, sz, ci]
    lib.rans_decoder_decode_z.argtypes = [vp, sz, ci, ci, ci]
    lib.rans_decoder_decoded_size.argtypes = [vp]
    lib.rans_decoder_decoded_size.restype = sz
    lib.rans_decoder_get_decoded.argtypes = [vp, i32p]

    lib.pmf_to_quantized_cdf_c.argtypes = [f32p, ci, ci, i32p]
    _lib = lib
    return _lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    """(n,) float pmf -> (n+1,) int32 quantized CDF with total 2^precision."""
    lib = get_lib()
    pmf = np.ascontiguousarray(pmf, dtype=np.float32)
    out = np.zeros(len(pmf) + 1, np.int32)
    lib.pmf_to_quantized_cdf_c(
        pmf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pmf), precision,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


class RansEncoder:
    def __init__(self):
        self._lib = get_lib()
        self._h = self._lib.rans_encoder_new()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rans_encoder_free(self._h)
            self._h = None

    def reset(self):
        self._lib.rans_encoder_reset(self._h)

    def set_use_two_encoders(self, two: bool):
        self._lib.rans_encoder_set_two(self._h, int(two))

    def add_cdf(self, cdfs: np.ndarray, lengths: np.ndarray,
                offsets: np.ndarray) -> int:
        cdfs = _i32(cdfs)
        lengths = _i32(lengths).reshape(-1)
        offsets = _i32(offsets).reshape(-1)
        n_rows, row_len = cdfs.shape
        return self._lib.rans_encoder_add_cdf(
            self._h,
            cdfs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_rows, row_len)

    def encode_with_indexes(self, symbols, indexes, group: int):
        symbols = np.ascontiguousarray(symbols, dtype=np.int16).reshape(-1)
        indexes = _i32(indexes).reshape(-1)
        self._lib.rans_encoder_encode_with_indexes(
            self._h,
            symbols.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            indexes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(symbols), group)

    def encode_y(self, packed, group: int):
        packed = np.ascontiguousarray(packed, dtype=np.int16).reshape(-1)
        self._lib.rans_encoder_encode_y(
            self._h, packed.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            len(packed), group)

    def encode_z(self, symbols, group: int, start_offset: int,
                 per_channel_size: int):
        symbols = np.ascontiguousarray(symbols, dtype=np.int8).reshape(-1)
        self._lib.rans_encoder_encode_z(
            self._h, symbols.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            len(symbols), group, start_offset, per_channel_size)

    def flush(self):
        self._lib.rans_encoder_flush(self._h)

    def get_encoded_stream(self) -> bytes:
        n = self._lib.rans_encoder_stream_size(self._h)
        out = np.zeros(n, np.uint8)
        if n:
            self._lib.rans_encoder_get_stream(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out.tobytes()


class RansDecoder:
    def __init__(self):
        self._lib = get_lib()
        self._h = self._lib.rans_decoder_new()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rans_decoder_free(self._h)
            self._h = None

    def set_use_two_decoders(self, two: bool):
        self._lib.rans_decoder_set_two(self._h, int(two))

    def add_cdf(self, cdfs, lengths, offsets) -> int:
        cdfs = _i32(cdfs)
        lengths = _i32(lengths).reshape(-1)
        offsets = _i32(offsets).reshape(-1)
        n_rows, row_len = cdfs.shape
        return self._lib.rans_decoder_add_cdf(
            self._h,
            cdfs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_rows, row_len)

    def set_stream(self, stream: bytes):
        arr = np.frombuffer(stream, np.uint8)
        arr = np.ascontiguousarray(arr)
        self._lib.rans_decoder_set_stream(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(arr))

    def decode_batch(self, indexes, group: int):
        indexes = _i32(indexes).reshape(-1)
        self._lib.rans_decoder_decode_batch(
            self._h, indexes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(indexes), group)

    def decode_z(self, total_size: int, group: int, start_offset: int,
                 per_channel_size: int):
        self._lib.rans_decoder_decode_z(self._h, total_size, group,
                                        start_offset, per_channel_size)

    def get_decoded(self) -> np.ndarray:
        n = self._lib.rans_decoder_decoded_size(self._h)
        out = np.zeros(n, np.int32)
        if n:
            self._lib.rans_decoder_get_decoded(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out


class EntropyCoder:
    """One encoder and one decoder sharing their CDF tables."""

    def __init__(self):
        self.encoder = RansEncoder()
        self.decoder = RansDecoder()

    def reset(self):
        self.encoder.reset()

    def add_cdf(self, cdf, cdf_length, offset) -> int:
        enc_idx = self.encoder.add_cdf(cdf, cdf_length, offset)
        dec_idx = self.decoder.add_cdf(cdf, cdf_length, offset)
        assert enc_idx == dec_idx
        return enc_idx

    def encode_y(self, packed_symbols, cdf_group_index: int):
        self.encoder.encode_y(packed_symbols, cdf_group_index)

    def encode_z(self, symbols, cdf_group_index: int, start_offset: int,
                 per_channel_size: int):
        self.encoder.encode_z(symbols, cdf_group_index, start_offset,
                              per_channel_size)

    def encode_with_indexes(self, symbols, indexes, cdf_group_index: int):
        self.encoder.encode_with_indexes(symbols, indexes, cdf_group_index)

    def flush(self):
        self.encoder.flush()

    def get_encoded_stream(self) -> bytes:
        return self.encoder.get_encoded_stream()

    def set_stream(self, stream: bytes):
        self.decoder.set_stream(stream)

    def decode_y(self, indexes, cdf_group_index: int):
        self.decoder.decode_batch(indexes, cdf_group_index)

    def decode_z(self, total_size: int, cdf_group_index: int,
                 start_offset: int, per_channel_size: int):
        self.decoder.decode_z(total_size, cdf_group_index, start_offset,
                              per_channel_size)

    def get_decoded_tensor(self) -> np.ndarray:
        return self.decoder.get_decoded()

    def set_use_two_entropy_coders(self, two: bool):
        self.encoder.set_use_two_encoders(two)
        self.decoder.set_use_two_decoders(two)
