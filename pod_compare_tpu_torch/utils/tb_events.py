"""TensorBoard-compatible event files, first-party.

The port's own copy of ``pod_compare_tpu/utils/tb_events.py`` (it needs no
framework). detectron2 installs TensorBoard writers in its `default_setup`
so a human can monitor a 90k-iter run; the writer here needs no
`tensorboard` package and speaks the on-disk format directly — it is only
TFRecord framing around a tiny protobuf:

  record  := uint64 length | uint32 masked_crc32c(length) |
             bytes payload | uint32 masked_crc32c(payload)
  payload := Event proto:
     double wall_time = 1; int64 step = 2;
     string file_version = 3;          (first record: "brain.Event:2")
     Summary summary = 5;
  Summary := repeated Value value = 1;
  Value   := string tag = 1; float simple_value = 2;

CRC is CRC-32C (Castagnoli), masked per the TFRecord spec:
((crc >> 15 | crc << 17) + 0xa282ead8) mod 2^32. Any standard
TensorBoard build reads these files; `read_events` round-trips them for
the tests.
"""

import os
import socket
import struct
import threading
import time
from typing import Dict, Iterator, Tuple

_CRC_TABLE = []


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reflected Castagnoli
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # protobuf int64 two's-complement
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _event_proto(wall_time: float, step: int = 0,
                 file_version: str = None,
                 scalars: Dict[str, float] = None) -> bytes:
    msg = bytearray()
    msg += b"\x09" + struct.pack("<d", wall_time)  # field 1, double
    if step:
        msg += b"\x10" + _varint(step)  # field 2, varint
    if file_version is not None:
        fv = file_version.encode()
        msg += b"\x1a" + _varint(len(fv)) + fv  # field 3, bytes
    if scalars:
        summary = bytearray()
        for tag, value in scalars.items():
            tb = tag.encode()
            val = bytearray()
            val += b"\x0a" + _varint(len(tb)) + tb  # Value.tag
            val += b"\x15" + struct.pack("<f", float(value))  # simple_value
            summary += b"\x0a" + _varint(len(val)) + bytes(val)
        msg += b"\x2a" + _varint(len(summary)) + bytes(summary)  # field 5
    return bytes(msg)


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class TBEventWriter:
    """Append-only scalar writer: `events.out.tfevents.<ts>.<host>`."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        )
        self.path = os.path.join(log_dir, fname)
        self._lock = threading.Lock()
        self._f = open(self.path, "ab")
        self._write(_event_proto(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        with self._lock:
            self._f.write(_record(payload))
            self._f.flush()

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        import math

        finite = {}
        for k, v in scalars.items():
            if not (isinstance(v, (int, float)) or hasattr(v, "__float__")):
                continue
            v = float(v)
            if math.isfinite(v):  # NaN mAP placeholders poison TB charts
                finite[k] = v
        if finite:
            self._write(_event_proto(time.time(), step=step, scalars=finite))

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def read_events(path: str) -> Iterator[Tuple[int, Dict[str, float]]]:
    """Minimal reader for tests: yields (step, {tag: value}) per record
    (skipping the file_version header), verifying both CRCs."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        assert hcrc == _masked_crc(header), "header CRC mismatch"
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack("<I",
                                data[pos + 12 + length:pos + 16 + length])
        assert pcrc == _masked_crc(payload), "payload CRC mismatch"
        pos += 16 + length

        # Decode the tiny Event subset we emit.
        step, scalars, is_version = 0, {}, False
        i = 0
        while i < len(payload):
            key = payload[i]
            i += 1
            field, wire = key >> 3, key & 7
            if wire == 1:  # 64-bit
                i += 8
            elif wire == 5:  # 32-bit
                i += 4
            elif wire == 0:  # varint
                v = 0
                shift = 0
                while True:
                    b = payload[i]
                    i += 1
                    v |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if field == 2:
                    step = v
            elif wire == 2:  # length-delimited
                ln = 0
                shift = 0
                while True:
                    b = payload[i]
                    i += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                sub = payload[i:i + ln]
                i += ln
                if field == 3:
                    is_version = True
                elif field == 5:
                    j = 0
                    while j < len(sub):
                        assert sub[j] == 0x0A
                        j += 1
                        vlen = 0
                        shift = 0
                        while True:
                            b = sub[j]
                            j += 1
                            vlen |= (b & 0x7F) << shift
                            shift += 7
                            if not b & 0x80:
                                break
                        val = sub[j:j + vlen]
                        j += vlen
                        k = 0
                        tag, value = None, None
                        while k < len(val):
                            if val[k] == 0x0A:
                                k += 1
                                tlen = 0
                                shift = 0
                                while True:
                                    b = val[k]
                                    k += 1
                                    tlen |= (b & 0x7F) << shift
                                    shift += 7
                                    if not b & 0x80:
                                        break
                                tag = val[k:k + tlen].decode()
                                k += tlen
                            elif val[k] == 0x15:
                                (value,) = struct.unpack(
                                    "<f", val[k + 1:k + 5])
                                k += 5
                            else:
                                raise AssertionError(
                                    f"unexpected Value key {val[k]:#x}")
                        scalars[tag] = value
        if not is_version:
            yield step, scalars
