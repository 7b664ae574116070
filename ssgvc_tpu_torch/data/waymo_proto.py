"""A protobuf wire-format walker for Waymo ``Frame`` records, with no
protobuf package: it reads the fields the data path needs.

    Frame.images        = field 4 (repeated CameraImage)
    CameraImage.name    = field 1 (enum; FRONT = 1)
    CameraImage.image   = field 2 (bytes, JPEG)
    Frame.context.name  = context field 1 -> name field 1

JPEG decoding and encoding go through Pillow; ``build_frame_proto`` writes
the minimal Frame the walker reads (fixtures, synthetic datasets).
"""

from __future__ import annotations

import io
from typing import Dict, Iterator, Optional, Tuple

FRONT = 1  # CameraName.FRONT


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def iter_fields(data: memoryview) -> Iterator[Tuple[int, int, memoryview]]:
    """Yield (field_number, wire_type, payload) over one message: the value
    of a varint, else a view of the payload's bytes."""
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(data, pos)
            yield field, wire, val
        elif wire == 1:  # 64-bit
            yield field, wire, data[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(data, pos)
            yield field, wire, data[pos:pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            yield field, wire, data[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def parse_camera_images(frame_bytes: bytes) -> Dict[int, bytes]:
    """Frame proto -> {camera_name: jpeg_bytes}."""
    out: Dict[int, bytes] = {}
    for field, wire, payload in iter_fields(memoryview(frame_bytes)):
        if field == 4 and wire == 2:  # Frame.images
            name = None
            image = None
            for f2, w2, p2 in iter_fields(payload):
                if f2 == 1 and w2 == 0:
                    name = p2
                elif f2 == 2 and w2 == 2:
                    image = bytes(p2)
            if name is not None and image is not None:
                out[name] = image
    return out


def parse_front_jpeg(frame_bytes: bytes) -> Optional[bytes]:
    return parse_camera_images(frame_bytes).get(FRONT)


def parse_context_name(frame_bytes: bytes) -> Optional[str]:
    for field, wire, payload in iter_fields(memoryview(frame_bytes)):
        if field == 1 and wire == 2:  # Frame.context
            for f2, w2, p2 in iter_fields(payload):
                if f2 == 1 and w2 == 2:  # Context.name
                    return bytes(p2).decode("utf-8", "replace")
    return None


def decode_jpeg(jpeg_bytes: bytes):
    """JPEG -> (H, W, 3) uint8 RGB."""
    import numpy as np
    from PIL import Image

    img = Image.open(io.BytesIO(jpeg_bytes)).convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def encode_jpeg(rgb, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 RGB -> JPEG bytes."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _ld(field: int, payload: bytes) -> bytes:
    """A length-delimited field."""
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def build_frame_proto(jpeg_bytes: bytes, camera_name: int = FRONT,
                      context_name: str = "synthetic") -> bytes:
    """A minimal Frame proto: its context name and one camera image."""
    cam = _varint((1 << 3) | 0) + _varint(camera_name) + _ld(2, jpeg_bytes)
    return _ld(1, _ld(1, context_name.encode())) + _ld(4, cam)
