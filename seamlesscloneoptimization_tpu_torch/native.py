"""OpenCV-FileStorage YAML matrices and 24-bit BMP images, in numpy.

The port's own copy of the JAX package's native IO helpers (its
``native/__init__.py`` and the writer in ``native/src/scnative.cpp``), the
debugging artifacts' formats of the reference (write2Yaml,
seamlessClone-CUDA/seamlessClone_imp.h:49-63; writeBMP,
seamlessClone_imp.cu:68-190): the same YAML header, ``%.9g`` / ``%.17g``
float tokens, the data wrapped before column 68, and bottom-up 24-bit BMP
rows padded to 4 bytes. Plain Python and numpy: nothing is compiled.
"""

from __future__ import annotations

import re
import struct

import numpy as np

_DT = {"u": np.uint8, "s": np.int16, "i": np.int32, "f": np.float32, "d": np.float64}
_DT_FROM_NP = {np.dtype(v): k for k, v in _DT.items()}
_TOKEN = {"f": "%.9g", "d": "%.17g"}  # integers: "%d"
_WRAP = 68  # a data line ends before this column
_BMP_HEADER = struct.Struct("<HIIIIiiHHIIiiII")  # file header + BITMAPINFOHEADER, 54 bytes


def write_yaml_mat(path, arr: np.ndarray, name: str = "mat") -> None:
    """Write a 2-D (rows, cols) or 3-D (rows, cols, channels) array of
    uint8, int16, int32, float32 or float64 as an OpenCV FileStorage YAML
    matrix named ``name``."""
    arr = np.ascontiguousarray(arr)
    if arr.ndim == 2:
        (rows, cols), ch = arr.shape, 1
    elif arr.ndim == 3:
        rows, cols, ch = arr.shape
    else:
        raise ValueError("array must be 2-D or 3-D")
    dt = _DT_FROM_NP.get(arr.dtype)
    if dt is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    parts = [f"%YAML:1.0\n---\nmat_name: {name}\ndata: !!opencv-matrix\n",
             f"   rows: {rows}\n   cols: {cols}\n",
             f'   dt: "{ch}{dt}"\n' if ch > 1 else f"   dt: {dt}\n", "   data: [ "]
    fmt = _TOKEN.get(dt, "%d")
    values = arr.ravel().tolist()
    n, col = len(values), 0
    for i, v in enumerate(values):
        tok = fmt % v + ("," if i + 1 < n else "")
        if col + len(tok) + 1 > _WRAP:
            parts.append("\n       ")
            col = 7
        elif i:
            parts.append(" ")
            col += 1
        parts.append(tok)
        col += len(tok)
    parts.append(" ]\n")
    with open(path, "w") as f:
        f.write("".join(parts))


def _field(text: str, key: str) -> str:
    m = re.search(rf"^\s*{key}:\s*(.*)$", text, re.MULTILINE)
    if m is None:
        raise ValueError(f"missing {key}:")
    return m.group(1).strip().strip('"')


def read_yaml_mat(path) -> np.ndarray:
    """Read an OpenCV FileStorage YAML matrix -> (rows, cols) or (rows,
    cols, channels) ndarray."""
    with open(path) as f:
        text = f.read()
    head, sep, data = text.partition("data: [")
    if not sep:
        head, sep, data = text.rpartition("data:")
        data = data[data.index("[") + 1 :]
    rows, cols = int(_field(head, "rows")), int(_field(head, "cols"))
    m = re.fullmatch(r"(\d*)([usifd])", _field(head, "dt"))
    if m is None:
        raise ValueError(f"{path}: unsupported dt {_field(head, 'dt')!r}")
    ch, dt = int(m.group(1) or 1), m.group(2)
    tokens = data[: data.index("]")].replace(",", " ").split()
    if len(tokens) != rows * cols * ch:
        raise ValueError(f"{path}: {len(tokens)} values for {rows}x{cols}x{ch}")
    wide = np.float64 if dt in "fd" else np.int64
    arr = np.array(tokens, dtype=wide).astype(_DT[dt])
    return arr.reshape((rows, cols) if ch == 1 else (rows, cols, ch))


def write_bmp(path, img: np.ndarray) -> None:
    """Write (H, W) or (H, W, 3) uint8 (BGR interleaved, top row first, as
    cv2.imread gives it) as an uncompressed 24-bit BMP; a gray image is
    written as three equal channels."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"image must be (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    row_bytes = (3 * w + 3) & ~3
    body = np.zeros((h, row_bytes), np.uint8)
    body[:, : 3 * w] = img[::-1].reshape(h, 3 * w)  # bottom-up
    size = row_bytes * h
    header = _BMP_HEADER.pack(0x4D42, _BMP_HEADER.size + size, 0, _BMP_HEADER.size, 40, w, h,
                              1, 24, 0, size, 2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header)
        f.write(body.tobytes())


def read_bmp(path) -> np.ndarray:
    """Read an uncompressed 24-bit BMP -> (H, W, 3) uint8 BGR, top row first."""
    with open(path, "rb") as f:
        raw = f.read()
    (magic, _, _, offset, _, w, h, _, bpp, compression, *_) = _BMP_HEADER.unpack_from(raw)
    if magic != 0x4D42 or bpp != 24 or compression != 0:
        raise ValueError(f"{path}: not an uncompressed 24-bit BMP")
    rows, row_bytes = abs(h), (3 * w + 3) & ~3
    body = np.frombuffer(raw, np.uint8, rows * row_bytes, offset).reshape(rows, row_bytes)
    img = body[:, : 3 * w].reshape(rows, w, 3)
    return (img[::-1] if h > 0 else img).copy()


__all__ = ["read_yaml_mat", "write_yaml_mat", "write_bmp", "read_bmp"]
