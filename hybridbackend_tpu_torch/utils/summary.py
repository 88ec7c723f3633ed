"""TensorBoard scalar summaries without TensorFlow or ``tensorboard``.

The port's own copy of ``hybridbackend_tpu/utils/summary.py:1-246``: the
JAX module imports no JAX, but importing it from the JAX package would
run ``hybridbackend_tpu/__init__.py``, which imports JAX. The event files
are byte for byte the JAX writer's for the same scalars, steps and wall
times (``tests/test_torch_summary.py``), and TensorBoard reads them.

The format (tensorflow/core/util/event.proto,
framework/summary.proto):

* ``Event``: ``double wall_time = 1; int64 step = 2;
  oneof {string file_version = 3; Summary summary = 5;}``
* ``Summary``: ``repeated Value value = 1`` with
  ``Value { string tag = 1; float simple_value = 2; }``
* TFRecord: ``uint64 len | masked_crc32c(len) | data |
  masked_crc32c(data)``, the mask being the Castagnoli CRC rotated and
  offset (``((crc >> 15) | (crc << 17)) + 0xa282ead8``).

Neither ``tensorboard`` nor ``torch.utils.tensorboard`` is needed, and
the machine with the card has neither.
"""


from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven in Python: the records are tiny.
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
  if not _CRC_TABLE:
    poly = 0x82F63B78
    for i in range(256):
      c = i
      for _ in range(8):
        c = (c >> 1) ^ (poly if c & 1 else 0)
      _CRC_TABLE.append(c)
  return _CRC_TABLE


def crc32c(data: bytes) -> int:
  table = _crc_table()
  crc = 0xFFFFFFFF
  for b in data:
    crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
  crc = crc32c(data)
  return (((crc >> 15) | (crc << 17)) + 0xa282ead8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf encoding.
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
  out = bytearray()
  while True:
    b = n & 0x7F
    n >>= 7
    if n:
      out.append(b | 0x80)
    else:
      out.append(b)
      return bytes(out)


def _tag(field: int, wire: int) -> bytes:
  return _varint((field << 3) | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
  return _tag(field, 2) + _varint(len(data)) + data


def _double_field(field: int, v: float) -> bytes:
  return _tag(field, 1) + struct.pack('<d', v)


def _float_field(field: int, v: float) -> bytes:
  return _tag(field, 5) + struct.pack('<f', v)


def _int64_field(field: int, v: int) -> bytes:
  if v < 0:
    v += 1 << 64
  return _tag(field, 0) + _varint(v)


def _scalar_event(step: int, wall_time: float,
                  scalars: Dict[str, float]) -> bytes:
  summary = b''.join(
      _bytes_field(1, _bytes_field(1, tag.encode('utf-8'))
                   + _float_field(2, float(val)))
      for tag, val in scalars.items())
  return (_double_field(1, wall_time) + _int64_field(2, int(step))
          + _bytes_field(5, summary))


def _version_event(wall_time: float) -> bytes:
  return _double_field(1, wall_time) + _bytes_field(3, b'brain.Event:2')


class SummaryWriter:
  """Append-only TF event-file writer (thread-safe).

  Usage::

      w = SummaryWriter(model_dir)
      w.scalar('train/loss', 0.3, step=100)
      w.scalars(200, {'train/loss': 0.25, 'train/auc': 0.71})
      w.close()
  """

  def __init__(self, logdir: str, filename_suffix: str = ''):
    os.makedirs(logdir, exist_ok=True)
    fname = (f'events.out.tfevents.{int(time.time())}.'
             f'{socket.gethostname()}.{os.getpid()}{filename_suffix}')
    self.path = os.path.join(logdir, fname)
    self._f = open(self.path, 'ab')
    self._lock = threading.Lock()
    self._write(_version_event(time.time()))

  def _write(self, event: bytes) -> None:
    header = struct.pack('<Q', len(event))
    rec = (header + struct.pack('<I', _masked_crc(header))
           + event + struct.pack('<I', _masked_crc(event)))
    with self._lock:
      self._f.write(rec)

  def scalar(self, tag: str, value: float, step: int) -> None:
    self._write(_scalar_event(step, time.time(), {tag: value}))

  def scalars(self, step: int, values: Dict[str, float]) -> None:
    if values:
      self._write(_scalar_event(step, time.time(), values))

  def flush(self) -> None:
    with self._lock:
      self._f.flush()

  def close(self) -> None:
    with self._lock:
      if not self._f.closed:
        self._f.flush()
        self._f.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


# ---------------------------------------------------------------------------
# The reader, for tests and offline tools (TensorBoard is the viewer).
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
  out = shift = 0
  while True:
    b = buf[pos]
    pos += 1
    out |= (b & 0x7F) << shift
    if not b & 0x80:
      return out, pos
    shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
  pos = 0
  while pos < len(buf):
    key, pos = _read_varint(buf, pos)
    field, wire = key >> 3, key & 7
    if wire == 0:
      val, pos = _read_varint(buf, pos)
    elif wire == 1:
      val = struct.unpack('<d', buf[pos:pos + 8])[0]
      pos += 8
    elif wire == 2:
      ln, pos = _read_varint(buf, pos)
      val = buf[pos:pos + ln]
      pos += ln
    elif wire == 5:
      val = struct.unpack('<f', buf[pos:pos + 4])[0]
      pos += 4
    else:
      raise ValueError(f'unsupported wire type {wire}')
    yield field, wire, val


def read_event_scalars(path: str) -> List[Tuple[int, str, float]]:
  """Parse an event file into ``[(step, tag, value), ...]`` (validates
  the record CRCs)."""
  out: List[Tuple[int, str, float]] = []
  with open(path, 'rb') as f:
    data = f.read()
  pos = 0
  while pos < len(data):
    (length,) = struct.unpack('<Q', data[pos:pos + 8])
    (hcrc,) = struct.unpack('<I', data[pos + 8:pos + 12])
    if hcrc != _masked_crc(data[pos:pos + 8]):
      raise ValueError(f'bad header crc at {pos}')
    body = data[pos + 12:pos + 12 + length]
    (dcrc,) = struct.unpack('<I',
                            data[pos + 12 + length:pos + 16 + length])
    if dcrc != _masked_crc(body):
      raise ValueError(f'bad data crc at {pos}')
    pos += 16 + length
    step = 0
    summary = None
    for field, _, val in _iter_fields(body):
      if field == 2:
        step = int(val)
      elif field == 5:
        summary = val
    if summary is None:
      continue
    for field, _, val in _iter_fields(summary):
      if field != 1:
        continue
      tag, simple = None, None
      for f2, _, v2 in _iter_fields(val):
        if f2 == 1:
          tag = v2.decode('utf-8')
        elif f2 == 2:
          simple = float(v2)
      if tag is not None and simple is not None:
        out.append((step, tag, simple))
  return out


__all__ = ['SummaryWriter', 'read_event_scalars', 'crc32c']
