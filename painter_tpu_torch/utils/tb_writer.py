"""Dependency-free TensorBoard event-file writer.

The reference logs train scalars to TensorBoard
(``Painter/main_train.py:280-284``, ``engine_train.py:104-110``); this
repo's primary stream is the JSON-lines ``scalars.jsonl`` (readable
without any tooling), and this module additionally emits a standard
``events.out.tfevents.*`` file so real hosts can point ``tensorboard
--logdir`` at the run directory. No tensorboard/tensorflow import is
needed: a TFRecord is ``len(8B) | masked_crc32c(len)(4B) | payload |
masked_crc32c(payload)(4B)`` and the payload is a tiny ``tf.Event``
protobuf (wall_time=1:double, step=2:int64, file_version=3:string,
summary=5 { value=1 { tag=1:string, simple_value=2:float } }), both
hand-encoded below. The PyTorch port's copy of
``painter_tpu/utils/tb_writer.py``, byte for byte the same records.
"""
from __future__ import annotations

import os
import socket
import struct
import time

# crc32c (Castagnoli), table-driven; TensorBoard validates these.
_CRC_TABLE = []
_POLY = 0x82F63B78
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ (_POLY if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf wire encoding (varint + tagged fields) --

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _event(wall_time: float, step: int = None, file_version: str = None,
           scalars: dict = None) -> bytes:
    msg = _field_double(1, wall_time)
    if step is not None:
        msg += _field_varint(2, step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field_bytes(1, _field_bytes(1, tag.encode())
                         + _field_float(2, float(val)))
            for tag, val in scalars.items())
        msg += _field_bytes(5, summary)
    return msg


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


class EventWriter:
    """Append-only tfevents writer for scalar summaries."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.0")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        now = time.time()
        self._f.write(_record(_event(now, file_version="brain.Event:2")))
        self._f.flush()

    def add_scalars(self, step: int, scalars: dict,
                    wall_time: float = None) -> None:
        self._f.write(_record(_event(
            wall_time if wall_time is not None else time.time(),
            step=step, scalars=scalars)))
        self._f.flush()

    def close(self) -> None:
        self._f.close()
