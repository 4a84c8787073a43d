"""Metrics sink: TensorBoard-compatible event files, written natively.

The reference logs ~30 scalars/iter through torch's SummaryWriter
(bbc/rsl_rl/runners/on_policy_runner.py:238-304).  We write the same event
format ourselves — TFRecord framing (length + masked crc32c) around
hand-encoded `Event` protobufs — so no TF/torch dependency sits on the
training path and the files open in standard TensorBoard.
"""
from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf encoding for Event/Summary
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double_field(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _int64_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _scalar_event(step: int, wall_time: float, tag: str, value: float) -> bytes:
    # Summary.Value { tag = 1 (string), simple_value = 2 (float) }
    val = _bytes_field(1, tag.encode()) + _float_field(2, float(value))
    summary = _bytes_field(1, val)  # Summary { value = 1 (repeated) }
    # Event { wall_time = 1 (double), step = 2 (int64), summary = 5 }
    return _double_field(1, wall_time) + _int64_field(2, step) + _bytes_field(5, summary)


def _file_version_event(wall_time: float) -> bytes:
    return _double_field(1, wall_time) + _bytes_field(3, b"brain.Event:2")


class MetricWriter:
    """Append-only TensorBoard event-file writer."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._write_record(_file_version_event(time.time()))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int):
        self._write_record(_scalar_event(step, time.time(), tag, value))

    def scalars(self, metrics: dict, step: int):
        for k, v in metrics.items():
            self.scalar(k, float(v), step)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
