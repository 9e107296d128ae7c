# Port copy of recom_tpu/importers/protowire.py: only the package name in imports differs.
"""Minimal protobuf wire-format reader/writer.

TensorFlow is not a dependency of this framework, but its GraphDef container
is just protobuf wire format — a generic tag/length walk is ~100 lines and
lets the TF importer (tf_graph.py) parse frozen graphs without TF installed.
The writer half exists so tests can synthesize GraphDef bytes the way TF
would emit them.

Wire types used by GraphDef/NodeDef/AttrValue/TensorProto:
  0 = varint, 1 = fixed64, 2 = length-delimited, 5 = fixed32
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple, Union


# --------------------------- reading ---------------------------------------


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield (field_number, wire_type, value).  Length-delimited values are
    raw bytes; varints are ints; fixed32/64 raw little-endian bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = read_varint(buf, pos)
        field, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == 2:
            length, pos = read_varint(buf, pos)
            val = buf[pos : pos + length]
            pos += length
        elif wtype == 5:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield field, wtype, val


def fields_dict(buf: bytes) -> Dict[int, List]:
    """All fields grouped by number (repeated fields keep order)."""
    out: Dict[int, List] = {}
    for field, _, val in iter_fields(buf):
        out.setdefault(field, []).append(val)
    return out


def zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def to_signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def read_fixed32_float(b: bytes) -> float:
    return struct.unpack("<f", b)[0]


def read_fixed64_double(b: bytes) -> float:
    return struct.unpack("<d", b)[0]


# --------------------------- writing ---------------------------------------


def write_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def field_varint(field: int, v: int) -> bytes:
    return write_varint((field << 3) | 0) + write_varint(v & ((1 << 64) - 1))


def field_bytes(field: int, data: bytes) -> bytes:
    return write_varint((field << 3) | 2) + write_varint(len(data)) + data


def field_float(field: int, v: float) -> bytes:
    return write_varint((field << 3) | 5) + struct.pack("<f", v)
