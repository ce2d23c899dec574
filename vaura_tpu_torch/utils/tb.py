"""TensorBoard event files, written with the standard library and numpy.

Counterpart of ``vaura_tpu/utils/tb.py``, with the same surface
(``add_custom_scalar_layout``, ``scalar``, ``scalars_per_codebook``,
``audio``, ``video``, ``histogram``, ``flush``, ``close``) and the same
records. The JAX logger writes through ``tensorboardX`` and PIL, and turns
itself off where ``tensorboardX`` is missing. This one depends on neither
and always writes:

  * TFRecord framing: ``uint64`` length, masked CRC-32C of the length, the
    record, masked CRC-32C of the record;
  * the ``Event`` / ``Summary`` protobuf messages, encoded field by field
    (``_Proto``): simple values, histograms, audio, images and the
    custom-scalars plugin's layout;
  * audio as 16-bit PCM WAV bytes (``ops/audio.write_wav``);
  * video as an animated GIF89a (``encode_gif``: LZW over a fixed palette,
    256 grays when every frame is gray, else 6 x 7 x 6 levels of red, green
    and blue).

Histograms take the bucket limits that ``tensorboardX``'s ``add_histogram``
takes by default (``DEFAULT_BINS``) and the same trimming of empty buckets.
"""

from __future__ import annotations

import io
import os
import socket
import struct
import time
from typing import Dict, List, Sequence

import numpy as np

from vaura_tpu_torch.ops.audio import write_wav


# --------------------------------------------------------------------------
# CRC-32C (Castagnoli) and the TFRecord framing
def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return b"".join((header, struct.pack("<I", masked_crc32c(header)), data,
                     struct.pack("<I", masked_crc32c(data))))


# --------------------------------------------------------------------------
# protobuf wire format
def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative int64 as ten bytes, as protobuf does
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class _Proto:
    """A message under construction: each call appends one field."""

    def __init__(self):
        self.parts: List[bytes] = []

    def _key(self, field: int, wire: int) -> None:
        self.parts.append(_varint(field << 3 | wire))

    def int(self, field: int, v: int) -> "_Proto":
        self._key(field, 0)
        self.parts.append(_varint(int(v)))
        return self

    def double(self, field: int, v: float) -> "_Proto":
        self._key(field, 1)
        self.parts.append(struct.pack("<d", float(v)))
        return self

    def float(self, field: int, v: float) -> "_Proto":
        self._key(field, 5)
        self.parts.append(struct.pack("<f", float(v)))
        return self

    def bytes(self, field: int, v) -> "_Proto":
        if isinstance(v, _Proto):
            v = v.encode()
        elif isinstance(v, str):
            v = v.encode("utf-8")
        self._key(field, 2)
        self.parts.append(_varint(len(v)))
        self.parts.append(v)
        return self

    def doubles(self, field: int, vs: Sequence[float]) -> "_Proto":
        """A packed repeated double field."""
        return self.bytes(field, np.asarray(vs, "<f8").tobytes())

    def encode(self) -> bytes:
        return b"".join(self.parts)


# Event: wall_time 1, step 2, file_version 3, summary 5
# Summary: value 1; Summary.Value: tag 1, simple_value 2, image 4, histo 5,
#   audio 6, tensor 8, metadata 9
def _event(summary_value: _Proto, step: int) -> bytes:
    ev = _Proto().double(1, time.time())
    if step:
        ev.int(2, step)
    return ev.bytes(5, _Proto().bytes(1, summary_value)).encode()


def _read_varint(data: bytes, i: int):
    v, shift = 0, 0
    while True:
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, i


def _fields(data: bytes):
    """``(field, value)`` of one message: ints for varints, bytes for
    length-delimited fields, raw little-endian bytes for fixed ones."""
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(data, i)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            v, i = data[i:i + n], i + n
        elif wire == 2:
            n, i = _read_varint(data, i)
            v, i = data[i:i + n], i + n
        else:
            raise ValueError(f"wire type {wire}")
        yield field, v


_KINDS = {2: "scalar", 4: "image", 5: "histogram", 6: "audio", 8: "tensor"}


def read_events(path: str) -> List[dict]:
    """The summary values of an event file, in order: ``{"step", "tag",
    "kind"}`` (``scalar`` values also under ``"value"``), each record's
    CRCs checked. What the Trainer's caller reads where ``tensorboard`` is
    not installed."""
    with open(path, "rb") as f:
        data = f.read()
    out, i = [], 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        record = data[i + 12:i + 12 + n]
        (crc_rec,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if crc != masked_crc32c(header) or crc_rec != masked_crc32c(record):
            raise ValueError(f"{path}: CRC mismatch at byte {i}")
        i += 16 + n
        step, summary = 0, None
        for field, v in _fields(record):
            if field == 2:
                step = v
            elif field == 5:
                summary = v
        for field, value in _fields(summary or b""):
            if field != 1:
                continue
            entry = {"step": step}
            for f, v in _fields(value):
                if f == 1:
                    entry["tag"] = v.decode("utf-8")
                elif f in _KINDS:
                    entry["kind"] = _KINDS[f]
                    if f == 2:
                        entry["value"] = struct.unpack("<f", v)[0]
            out.append(entry)
    return out


# --------------------------------------------------------------------------
# histograms: the default bins and bucket trimming of tensorboardX
def _default_bins() -> List[float]:
    v, buckets, neg = 1e-12, [], []
    while v < 1e20:
        buckets.append(v)
        neg.append(-v)
        v *= 1.1
    return neg[::-1] + [0] + buckets


DEFAULT_BINS = _default_bins()


def histogram_fields(values: np.ndarray) -> Dict[str, object]:
    """``min, max, num, sum, sum_squares, bucket_limit, bucket`` of
    ``values`` over ``DEFAULT_BINS``, keeping the buckets from one before
    the first non-empty one to the last non-empty one."""
    values = np.asarray(values).astype(float).reshape(-1)
    if values.size == 0:
        raise ValueError("histogram of no values")
    counts, limits = np.histogram(values, bins=DEFAULT_BINS)
    cum = np.cumsum(np.greater(counts, 0))
    start, end = np.searchsorted(cum, [0, cum[-1] - 1], side="right")
    start, end = int(start), int(end) + 1
    counts = (counts[start - 1:end] if start > 0
              else np.concatenate([[0], counts[:end]]))
    limits = limits[start:end + 1]
    return {"min": values.min(), "max": values.max(), "num": len(values),
            "sum": values.sum(), "sum_squares": values.dot(values),
            "bucket_limit": limits.tolist(), "bucket": counts.tolist()}


# --------------------------------------------------------------------------
# animated GIF
_GRAY_PALETTE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
_LEVELS = (6, 7, 6)  # red, green, blue
_COLOR_PALETTE = np.zeros((256, 3), np.uint8)
_COLOR_PALETTE[:252] = np.stack(np.meshgrid(
    *[np.round(np.linspace(0, 255, n)) for n in _LEVELS], indexing="ij"),
    axis=-1).reshape(-1, 3)


def _palette_indices(frames: np.ndarray):
    """``(palette [256, 3], indices [T, H, W] uint8)``: the gray palette
    when every pixel is gray (exact), else the fixed colour cube (nearest
    level per channel)."""
    if (frames[..., 0] == frames[..., 1]).all() and (
            frames[..., 0] == frames[..., 2]).all():
        return _GRAY_PALETTE, frames[..., 0]
    lv = [np.rint(frames[..., c].astype(np.float32) * (n - 1) / 255.0)
          .astype(np.uint8) for c, n in enumerate(_LEVELS)]
    idx = (lv[0] * (_LEVELS[1] * _LEVELS[2]) + lv[1] * _LEVELS[2] + lv[2])
    return _COLOR_PALETTE, idx.astype(np.uint8)


def _lzw(data: bytes) -> bytes:
    """GIF's variable-width LZW of 8-bit indices: codes of 9 to 12 bits,
    packed least significant bit first, a clear code when the table is
    full."""
    clear, eoi = 256, 257
    codes, widths = [clear], [9]
    add_code, add_width = codes.append, widths.append
    size, nxt = 9, 258
    table: Dict[int, int] = {}
    get = table.get
    it = iter(data)
    w = next(it)
    for k in it:
        key = w << 8 | k
        c = get(key)
        if c is not None:
            w = c
            continue
        add_code(w)
        add_width(size)
        # the decoder adds an entry after each code it reads and widens
        # its codes when the table reaches 2^size: the same test here
        if nxt >= 1 << size and size < 12:
            size += 1
        if nxt < 4095:
            table[key] = nxt
            nxt += 1
        else:
            add_code(clear)
            add_width(size)
            table.clear()
            size, nxt = 9, 258
        w = k
    add_code(w)
    add_width(size)
    if nxt >= 1 << size and size < 12:
        size += 1
    add_code(eoi)
    add_width(size)
    c = np.asarray(codes, np.uint32)
    wd = np.asarray(widths, np.uint8)
    bits = (c[:, None] >> np.arange(12, dtype=np.uint32)) & 1
    bits = bits[np.arange(12)[None, :] < wd[:, None]].astype(np.uint8)
    return np.packbits(bits, bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def encode_gif(frames: np.ndarray, duration_ms: int) -> bytes:
    """``frames [T, H, W, 3]`` uint8 -> an animated GIF89a that loops, each
    frame shown ``duration_ms`` (in GIF's hundredths of a second)."""
    T, H, W, _ = frames.shape
    palette, idx = _palette_indices(frames)
    delay = max(1, int(round(duration_ms / 10)))
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", W, H, 0xF7, 0, 0)  # 256-entry global table
    out += palette.tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"  # loop forever
    for t in range(T):
        out += b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0)
        out += b"\x08" + _sub_blocks(_lzw(np.ascontiguousarray(idx[t]).tobytes()))
    out += b"\x3b"
    return bytes(out)


# --------------------------------------------------------------------------
class TBLogger:
    """One event file under ``log_dir``, written as the calls come."""

    def __init__(self, log_dir: str, experiment_name: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            str(log_dir), f"events.out.tfevents.{int(time.time()):010d}."
            f"{socket.gethostname()}.{os.getpid()}")
        self._file = open(self.path, "ab")
        self._write(_Proto().double(1, time.time())
                    .bytes(3, "brain.Event:2").encode())

    def _write(self, event: bytes) -> None:
        self._file.write(tfrecord(event))

    def _value(self, value: _Proto, step: int) -> None:
        self._write(_event(value, step))

    def add_custom_scalar_layout(self, num_codebooks: int) -> None:
        """Group the per-codebook losses in one multiline chart per stage
        (reference ``vaura_model.py:739-773``)."""
        category = _Proto().bytes(1, "metrics")
        for stage in ("train", "val"):
            chart = _Proto().bytes(1, f"{stage}_loss_per_codebook")
            tags = _Proto()
            for i in range(num_codebooks):
                tags.bytes(1, f"{stage}_loss_per_codebook_{i}")
            category.bytes(2, chart.bytes(2, tags))
        layout = _Proto().bytes(2, category)  # Layout.category
        # TensorProto: dtype DT_STRING (7), an empty shape, string_val
        tensor = _Proto().int(1, 7).bytes(2, b"").bytes(8, layout)
        metadata = _Proto().bytes(1, _Proto().bytes(1, "custom_scalars"))
        self._value(_Proto().bytes(1, "custom_scalars__config__")
                    .bytes(8, tensor).bytes(9, metadata), 0)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._value(_Proto().bytes(1, tag).float(2, float(value)), step)

    def scalars_per_codebook(
        self, prefix: str, values: Sequence[float], step: int
    ) -> None:
        for i, v in enumerate(np.asarray(values).tolist()):
            self.scalar(f"{prefix}_{i}", v, step)

    def audio(self, tag: str, wav: np.ndarray, step: int,
              sample_rate: int) -> None:
        """wav: [T] or [1, T] float in [-1, 1], as 16-bit PCM WAV."""
        wav = np.asarray(wav, np.float32).reshape(1, -1)
        buf = io.BytesIO()
        write_wav(buf, wav, sample_rate)
        audio = (_Proto().float(1, float(sample_rate)).int(2, 1)
                 .int(3, wav.shape[-1]).bytes(4, buf.getvalue())
                 .bytes(5, "audio/wav"))
        self._value(_Proto().bytes(1, tag).bytes(6, audio), step)

    def video(self, tag: str, frames: np.ndarray, step: int,
              fps: float) -> None:
        """frames: [T, H, W, C] uint8 or [N, T, C, H, W] float in [0, 1];
        an animated GIF image summary."""
        frames = np.asarray(frames)
        if frames.ndim == 5:  # [N, T, C, H, W] -> first clip, [T, H, W, C]
            frames = frames[0].transpose(0, 2, 3, 1)
        if frames.dtype != np.uint8:
            frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
        if frames.shape[-1] == 1:
            frames = np.repeat(frames, 3, axis=-1)
        gif = encode_gif(frames, max(1, int(1000 / max(fps, 1e-3))))
        h, w = frames.shape[1:3]
        image = _Proto().int(1, h).int(2, w).int(3, 3).bytes(4, gif)
        self._value(_Proto().bytes(1, tag).bytes(4, image), step)

    def histogram(self, tag: str, values: np.ndarray, step: int) -> None:
        f = histogram_fields(values)
        histo = _Proto()
        for field, key in enumerate(("min", "max", "num", "sum",
                                     "sum_squares"), start=1):
            histo.double(field, f[key])
        histo.doubles(6, f["bucket_limit"]).doubles(7, f["bucket"])
        self._value(_Proto().bytes(1, tag).bytes(5, histo), step)

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()
