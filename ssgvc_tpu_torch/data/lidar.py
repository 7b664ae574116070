"""The top lidar projected onto the FRONT camera.

A Waymo Frame proto stores, per laser, a zlib-compressed MatrixFloat range
image [H, W, 4] (range, intensity, elongation, no-label-zone) and a
MatrixInt32 camera projection [H, W, 6] ((camera, u, v) twice). The
projection channels already hold pixel coordinates, so no 3-D math is
needed.

Proto field numbers: Frame.lasers=5, Laser.name=1, Laser.ri_return1=2,
RangeImage.range_image_compressed=2, RangeImage.camera_projection_compressed
=3; MatrixFloat / MatrixInt32: data=1 (packed), shape=2 (MatrixShape.dims=1,
packed).
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np

from .waymo_proto import FRONT, _ld, _read_varint, _varint, iter_fields

TOP_LIDAR = 1  # LaserName.TOP


def _parse_packed_shape(payload: memoryview) -> Tuple[int, ...]:
    dims = []
    for f, w, p in iter_fields(payload):
        if f == 1:
            if w == 0:
                dims.append(p)
            elif w == 2:  # packed varints
                pos = 0
                while pos < len(p):
                    v, pos = _read_varint(p, pos)
                    dims.append(v)
    return tuple(dims)


def parse_matrix_float(data: bytes) -> np.ndarray:
    arr = None
    shape: Tuple[int, ...] = ()
    for f, w, p in iter_fields(memoryview(data)):
        if f == 1 and w == 2:  # packed floats
            arr = np.frombuffer(bytes(p), np.float32)
        elif f == 2 and w == 2:
            shape = _parse_packed_shape(p)
    if arr is None:
        raise ValueError("MatrixFloat without data")
    return arr.reshape(shape) if shape else arr


def parse_matrix_int32(data: bytes) -> np.ndarray:
    vals = None
    shape: Tuple[int, ...] = ()
    for f, w, p in iter_fields(memoryview(data)):
        if f == 1 and w == 2:  # packed varints
            out = []
            pos = 0
            while pos < len(p):
                v, pos = _read_varint(p, pos)
                # a negative int32 is a 10-byte varint (two's complement)
                out.append(v - (1 << 64) if v >= (1 << 63) else v)
            vals = np.asarray(out, np.int32)
        elif f == 2 and w == 2:
            shape = _parse_packed_shape(p)
    if vals is None:
        raise ValueError("MatrixInt32 without data")
    return vals.reshape(shape) if shape else vals


def extract_laser_blobs(frame_bytes: bytes, laser_name: int = TOP_LIDAR
                        ) -> Optional[Tuple[bytes, bytes]]:
    """Frame proto -> (range_image_compressed, camera_projection_compressed)
    of the laser's first return, or None."""
    for field, wire, payload in iter_fields(memoryview(frame_bytes)):
        if field != 5 or wire != 2:  # Frame.lasers
            continue
        name = None
        ri1 = None
        for f2, w2, p2 in iter_fields(payload):
            if f2 == 1 and w2 == 0:
                name = p2
            elif f2 == 2 and w2 == 2:
                ri1 = p2
        if name != laser_name or ri1 is None:
            continue
        ri_blob = cam_blob = None
        for f3, w3, p3 in iter_fields(ri1):
            if f3 == 2 and w3 == 2:
                ri_blob = bytes(p3)
            elif f3 == 3 and w3 == 2:
                cam_blob = bytes(p3)
        if ri_blob is not None and cam_blob is not None:
            return ri_blob, cam_blob
    return None


def project_top_lidar(frame_bytes: bytes, height: int, width: int,
                      camera_name: int = FRONT,
                      mode: str = "occupancy") -> np.ndarray:
    """(H, W, 3) float32 projection aligned to the camera image; zeros
    where no point lands, and everywhere when the frame has no top lidar.

    ``mode='occupancy'``: channel 0 occupancy, 1 range / 75 m clipped to
    [0, 1], 2 intensity clipped to [0, 1]. ``mode='legacy3'``: range / 75,
    clip(intensity, 0, 1.5) / 1.5, elongation / 1.5 (the range stands in
    for the camera-frame depth).
    """
    proj = np.zeros((height, width, 3), np.float32)
    blobs = extract_laser_blobs(frame_bytes)
    if blobs is None:
        return proj
    ri = parse_matrix_float(zlib.decompress(blobs[0]))      # (H, W, 4)
    cp = parse_matrix_int32(zlib.decompress(blobs[1]))      # (H, W, 6)

    rng = ri[..., 0].reshape(-1)
    intensity = ri[..., 1].reshape(-1)
    elong = ri[..., 2].reshape(-1)
    cp = cp.reshape(-1, 6)
    for base in (0, 3):  # first and second projections
        cam = cp[:, base]
        u = cp[:, base + 1]
        v = cp[:, base + 2]
        keep = ((rng > 0) & (cam == camera_name)
                & (u >= 0) & (u < width) & (v >= 0) & (v < height))
        if mode == "legacy3":
            proj[v[keep], u[keep], 0] = rng[keep] / 75.0
            proj[v[keep], u[keep], 1] = np.clip(intensity[keep], 0, 1.5) / 1.5
            proj[v[keep], u[keep], 2] = elong[keep] / 1.5
        else:
            proj[v[keep], u[keep], 0] = 1.0
            proj[v[keep], u[keep], 1] = np.clip(rng[keep] / 75.0, 0, 1)
            proj[v[keep], u[keep], 2] = np.clip(intensity[keep], 0, 1)
    return proj


def build_range_image_blobs(range_image: np.ndarray,
                            cam_projection: np.ndarray) -> Tuple[bytes, bytes]:
    """The compressed MatrixFloat and MatrixInt32 blobs that
    :func:`project_top_lidar` parses (fixtures, synthetic frames)."""
    def shape_msg(shape):
        return _ld(1, b"".join(_varint(d) for d in shape))

    ri = range_image.astype(np.float32)
    mf = _ld(1, ri.reshape(-1).tobytes()) + _ld(2, shape_msg(ri.shape))

    cp = cam_projection.astype(np.int64)
    packed = b"".join(_varint(int(v) & ((1 << 64) - 1))
                      for v in cp.reshape(-1))
    mi = _ld(1, packed) + _ld(2, shape_msg(cp.shape))
    return zlib.compress(mf), zlib.compress(mi)


def build_laser_proto(ri_blob: bytes, cam_blob: bytes,
                      laser_name: int = TOP_LIDAR) -> bytes:
    """A Frame fragment with one laser (field 5)."""
    ri_msg = _ld(2, ri_blob) + _ld(3, cam_blob)
    laser = _varint((1 << 3) | 0) + _varint(laser_name) + _ld(2, ri_msg)
    return _ld(5, laser)
