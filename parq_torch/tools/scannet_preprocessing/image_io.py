"""Readers for the ScanNet frames the preprocessing opens, without PIL.

The JAX-side scripts open depth frames and the first color JPEG of a scene
with PIL (`Image.open`), which the card machine does not have. These
readers use `struct`, `zlib` and numpy only, and return what
`np.asarray(Image.open(path))` returns for the formats ScanNet exports:

- `read_pgm`: binary P5, maxval below 65536, 16-bit samples big-endian.
  A maxval other than 255 or 65535 is rescaled to 0..255 (8-bit) or
  0..65535 (16-bit) as Pillow's decoder rescales it.
- `read_png_gray`: 8- and 16-bit grayscale, not interlaced, every row
  filter (0-4), any number of IDAT chunks; every chunk's CRC checked.
- `jpeg_size`: (height, width) from the first SOF0/SOF1/SOF2 segment,
  without decoding.
- `read_depth`: a depth frame (P5 or PNG, told apart by their magic bytes)
  in meters: samples as float32, then divided by 1000 in float32
  (`depth_meters`).
"""
from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_WHITESPACE = b" \t\n\r\v\f"


def _pgm_tokens(data: bytes, count: int):
    """The first `count` header tokens of a PNM file after its magic, and
    the offset of the raster (one whitespace byte after the last token);
    '#' starts a comment that runs to the end of its line."""
    pos, tokens = 2, []
    while len(tokens) < count:
        if pos >= len(data):
            raise ValueError("PGM header ends early")
        ch = data[pos:pos + 1]
        if ch in _WHITESPACE:
            pos += 1
        elif ch == b"#":
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
        else:
            end = pos
            while end < len(data) and data[end:end + 1] not in \
                    _WHITESPACE + b"#":
                end += 1
            tokens.append(data[pos:end])
            pos = end
    if data[pos:pos + 1] not in _WHITESPACE:
        raise ValueError("PGM header is not followed by whitespace")
    return [int(t) for t in tokens], pos + 1


def read_pgm(path: str) -> np.ndarray:
    """(H, W) samples of a binary P5 file: uint8 when maxval < 256, else
    uint16 (big-endian in the file)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"P5":
        raise ValueError(f"{path}: not a binary PGM (P5)")
    (width, height, maxval), start = _pgm_tokens(data, 3)
    if not 0 < maxval < 65536:
        raise ValueError(f"{path}: maxval {maxval} outside 1..65535")
    dtype = np.dtype(np.uint8 if maxval < 256 else ">u2")
    if len(data) - start < width * height * dtype.itemsize:
        raise ValueError(f"{path}: raster shorter than {width}x{height}")
    raster = np.frombuffer(data, dtype, count=width * height, offset=start)
    out_max = 255 if maxval < 256 else 65535
    if maxval != out_max:
        # Pillow's PpmDecoder: min(out_max, round(value / maxval * out_max))
        raster = np.minimum(out_max, np.rint(
            raster.astype(np.float64) / maxval * out_max))
    return raster.astype(np.uint8 if out_max == 255 else np.uint16
                         ).reshape(height, width)


def _unfilter(rows: np.ndarray, height: int, width: int,
              bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters. rows (H, 1 + W*bpp) uint8, each led by
    its filter type → (H, W*bpp) uint8.

    Each byte depends on its left (a), upper (b) and upper-left (c)
    neighbours, so the bytes of one anti-diagonal of the (H, W) pixel grid
    are independent: H + W - 1 vectorised steps, every filter at once."""
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} is not 0-4")
    filtered = rows[:, 1:].reshape(height, width, bpp)
    if not kinds.any():
        return filtered.reshape(height, width * bpp).copy()
    filtered = filtered.astype(np.int32)
    recon = np.zeros((height + 1, width + 1, bpp), np.int32)  # zero border
    all_rows = np.arange(height)
    for d in range(height + width - 1):
        r = all_rows[max(0, d - width + 1):min(height, d + 1)]
        x = d - r
        a, b, c = recon[r + 1, x], recon[r, x + 1], recon[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        kind = kinds[r][:, None]
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        recon[r + 1, x + 1] = (filtered[r, x] + pred) & 0xFF
    return recon[1:, 1:].reshape(height, width * bpp).astype(np.uint8)


def read_png_gray(path: str) -> np.ndarray:
    """(H, W) samples of an 8-bit (uint8) or 16-bit (uint16) grayscale,
    non-interlaced PNG. Raises on any other PNG, on a bad CRC and on an
    unknown critical chunk."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{path}: PNG ends before IEND")
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if pos + 12 + n > len(data):
            raise ValueError(f"{path}: chunk {kind!r} runs past the file")
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind[0] & 0x20 == 0:     # critical chunk this reader lacks
            raise ValueError(f"{path}: unsupported critical chunk {kind!r}")
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, color, compression, method, interlace = header
    if color != 0 or depth not in (8, 16):
        raise ValueError(f"{path}: color type {color}, bit depth {depth}; "
                         "only 8- and 16-bit grayscale are read")
    if compression != 0 or method != 0 or interlace != 0:
        raise ValueError(f"{path}: compression {compression}, filter "
                         f"method {method}, interlace {interlace}")
    bpp = depth // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (1 + width * bpp):
        raise ValueError(f"{path}: {len(raw)} image bytes for "
                         f"{width}x{height}x{depth} bits")
    rows = np.frombuffer(raw, np.uint8).reshape(height, 1 + width * bpp)
    samples = _unfilter(rows, height, width, bpp)
    if bpp == 1:
        return samples
    return samples.view(">u2").astype(np.uint16).reshape(height, width)


def jpeg_size(path: str) -> Tuple[int, int]:
    """(height, width) of a JPEG from its first SOF0, SOF1 or SOF2 segment,
    skipping APPn and every other segment before it; nothing is decoded."""
    with open(path, "rb") as f:
        if f.read(2) != b"\xff\xd8":
            raise ValueError(f"{path}: not a JPEG")
        while True:
            if f.read(1) != b"\xff":
                raise ValueError(f"{path}: no marker where one should be")
            marker = f.read(1)
            while marker == b"\xff":               # fill bytes
                marker = f.read(1)
            if not marker:
                raise ValueError(f"{path}: ends before a frame header")
            m = marker[0]
            if m == 0x01 or 0xD0 <= m <= 0xD8:      # markers without a length
                continue
            if m in (0xD9, 0xDA):
                raise ValueError(f"{path}: no SOF0/1/2 before the scan")
            length, = struct.unpack(">H", f.read(2))
            if m in (0xC0, 0xC1, 0xC2):
                _, height, width = struct.unpack(">BHH", f.read(5))
                if height == 0 or width == 0:
                    raise ValueError(f"{path}: frame of {width}x{height}")
                return height, width
            if m in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE,
                     0xCF):
                raise ValueError(f"{path}: JPEG process SOF{m - 0xC0} is "
                                 "not read")
            f.seek(length - 2, 1)


def read_depth_samples(path: str) -> np.ndarray:
    """The raw (H, W) samples of a depth frame, P5 or PNG by magic bytes."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic[:2] == b"P5":
        return read_pgm(path)
    if magic == PNG_SIGNATURE:
        return read_png_gray(path)
    raise ValueError(f"{path}: neither a binary PGM nor a PNG")


def depth_meters(samples: np.ndarray, out=None) -> np.ndarray:
    """Depth samples (mm) in meters as the JAX-side script computes them:
    the samples as float32, divided by 1000 in float32; into `out` if
    given."""
    return np.divide(samples, np.float32(1000.0), out=out, dtype=np.float32)


def read_depth(path: str) -> np.ndarray:
    """A depth frame in meters, (H, W) float32 (`depth_meters`)."""
    return depth_meters(read_depth_samples(path))
