"""The bitstream container: SPS / I / P units, byte for byte the JAX
package's format, so either package reads the other's files.

Wire format (little-endian adaptive uints unless noted):
  unit   := type_byte payload
  type   := 0 SPS | 1 I | 2 P
  SPS    := sps_id, height, width, flags byte (use_ada_i | ec_part << 1)
  I/P    := sps_id, qp (1 byte), payload_len, payload bytes
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Dict, Optional, Tuple

NAL_SPS, NAL_I, NAL_P = 0, 1, 2


def write_uint_adaptive(f: BinaryIO, value: int):
    """1/2/4-byte escape coding: 0..253 in one byte; 254 -> u16; 255 -> u32."""
    if value < 254:
        f.write(bytes([value]))
    elif value < 65536:
        f.write(bytes([254]))
        f.write(struct.pack("<H", value))
    else:
        f.write(bytes([255]))
        f.write(struct.pack("<I", value))


def read_uint_adaptive(f: BinaryIO) -> int:
    b = f.read(1)
    if not b:
        raise EOFError
    v = b[0]
    if v < 254:
        return v
    if v == 254:
        return struct.unpack("<H", f.read(2))[0]
    return struct.unpack("<I", f.read(4))[0]


@dataclass(frozen=True)
class SPS:
    sps_id: int
    height: int
    width: int
    use_ada_i: bool = False
    ec_part: int = 0


class SPSHelper:
    """Id registry reusing ids for identical (h, w, use_ada_i, ec_part)."""

    def __init__(self):
        self._by_key: Dict[Tuple, int] = {}
        self._by_id: Dict[int, SPS] = {}

    def get_sps_id(self, height, width, use_ada_i=False, ec_part=0
                   ) -> Tuple[int, bool]:
        """Returns (sps_id, is_new)."""
        key = (height, width, bool(use_ada_i), int(ec_part))
        if key in self._by_key:
            return self._by_key[key], False
        sps_id = len(self._by_key)
        self._by_key[key] = sps_id
        self._by_id[sps_id] = SPS(sps_id, height, width, bool(use_ada_i),
                                  int(ec_part))
        return sps_id, True

    def get_sps(self, sps_id: int) -> SPS:
        return self._by_id[sps_id]

    def register(self, sps: SPS):
        key = (sps.height, sps.width, sps.use_ada_i, sps.ec_part)
        self._by_key[key] = sps.sps_id
        self._by_id[sps.sps_id] = sps


def write_sps(f: BinaryIO, sps: SPS):
    f.write(bytes([NAL_SPS]))
    write_uint_adaptive(f, sps.sps_id)
    write_uint_adaptive(f, sps.height)
    write_uint_adaptive(f, sps.width)
    f.write(bytes([int(sps.use_ada_i) | (int(sps.ec_part) << 1)]))


def write_ip(f: BinaryIO, is_i_frame: bool, sps_id: int, qp: int,
             payload: bytes):
    f.write(bytes([NAL_I if is_i_frame else NAL_P]))
    write_uint_adaptive(f, sps_id)
    f.write(bytes([qp & 0xFF]))
    write_uint_adaptive(f, len(payload))
    f.write(payload)


def read_unit(f: BinaryIO) -> Optional[dict]:
    head = f.read(1)
    if not head:
        return None
    nal_type = head[0]
    if nal_type == NAL_SPS:
        sps_id = read_uint_adaptive(f)
        height = read_uint_adaptive(f)
        width = read_uint_adaptive(f)
        flags = f.read(1)[0]
        return {"type": "sps",
                "sps": SPS(sps_id, height, width, bool(flags & 1), flags >> 1)}
    sps_id = read_uint_adaptive(f)
    qp = f.read(1)[0]
    length = read_uint_adaptive(f)
    payload = f.read(length)
    return {"type": "i" if nal_type == NAL_I else "p",
            "sps_id": sps_id, "qp": qp, "payload": payload}


class BitstreamWriter:
    """Whole-sequence writer managing SPS emission."""

    def __init__(self, f: BinaryIO):
        self.f = f
        self.sps_helper = SPSHelper()

    def write_frame(self, is_i: bool, height: int, width: int, qp: int,
                    payload: bytes, ec_part: int = 0):
        sps_id, is_new = self.sps_helper.get_sps_id(height, width,
                                                    ec_part=ec_part)
        if is_new:
            write_sps(self.f, self.sps_helper.get_sps(sps_id))
        write_ip(self.f, is_i, sps_id, qp, payload)


class BitstreamReader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.sps_helper = SPSHelper()

    def read_frame(self) -> Optional[dict]:
        while True:
            unit = read_unit(self.f)
            if unit is None:
                return None
            if unit["type"] == "sps":
                self.sps_helper.register(unit["sps"])
                continue
            unit["sps"] = self.sps_helper.get_sps(unit["sps_id"])
            return unit
