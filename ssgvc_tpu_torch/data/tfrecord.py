"""TFRecord files, the Waymo Open Dataset's container: the port's own
reader and writer. Each record is

    uint64  length        (little endian)
    uint32  masked_crc32c(length bytes)
    bytes   data[length]
    uint32  masked_crc32c(data)

CRC32C is the Castagnoli polynomial (reflected 0x82F63B78), masked as
((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff. The reader checks the
CRCs only when asked (``verify_crc``); the writer always writes them.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional

_POLY = 0x82F63B78
_CRC_TABLE: Optional[List[int]] = None


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    """CRC32C of ``data``, one table lookup per byte."""
    tab = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ tab[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield each record's payload; with ``verify_crc`` a bad CRC or a
    truncated record raises IOError."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (len_crc,) = struct.unpack("<I", header[8:12])
                if masked_crc32c(header[:8]) != len_crc:
                    raise IOError(f"{path}: corrupt length crc")
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"{path}: truncated record")
            data_crc_raw = f.read(4)
            if verify_crc:
                (data_crc,) = struct.unpack("<I", data_crc_raw)
                if masked_crc32c(data) != data_crc:
                    raise IOError(f"{path}: corrupt data crc")
            yield data


def count_records(path: str) -> int:
    """The number of records, from the headers alone."""
    return len(record_offsets(path))


def record_offsets(path: str) -> List[int]:
    """The byte offset of each record, for random access."""
    offsets = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos + 12 <= size:
            offsets.append(pos)
            f.seek(pos)
            (length,) = struct.unpack("<Q", f.read(8))
            pos += 12 + length + 4
    return offsets


def read_record_at(f, offset: int) -> bytes:
    """The payload of the record at ``offset`` of the open file ``f``."""
    f.seek(offset)
    (length,) = struct.unpack("<Q", f.read(8))
    f.seek(offset + 12)
    return f.read(length)


def write_records(path: str, records) -> None:
    """Write payloads as a TFRecord file, with their CRCs."""
    with open(path, "wb") as f:
        for data in records:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(data)
            f.write(struct.pack("<I", masked_crc32c(data)))
