"""OpenCV-FileStorage YAML matrices, 24-bit BMP images and the host's mask
prep, in numpy.

The port's own copy of the JAX package's native helpers (its
``native/__init__.py`` over ``native/src/scnative.cpp``): the reference's
fixture and debugging formats (readFromYaml, seamlessClone-CUDA/
seamlessClone_imp.cu:226-237; write2Yaml, seamlessClone_imp.h:49-63;
writeBMP, seamlessClone_imp.cu:68-190), byte for byte as the C++ writes
them: the same YAML header, ``%d`` / ``%.9g`` / ``%.17g`` tokens, the data
wrapped before column 68, bottom-up 24-bit BMP rows padded to 4 bytes; and
``prep_mask``. Plain Python and numpy, vectorized (no Python loop over
the values): nothing is compiled.
"""

from __future__ import annotations

import os
import re
import struct
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_DT = {"u": np.uint8, "s": np.int16, "i": np.int32, "f": np.float32, "d": np.float64}
_DT_FROM_NP = {np.dtype(v): k for k, v in _DT.items()}
_TOKEN = {"f": "%.9g", "d": "%.17g"}  # integers: "%d"
_WRAP = 68  # a data line ends before this column
_SPACE, _NEWLINE = ord(" "), ord("\n")
_TABLE_SPAN = 1 << 17  # integer tokens from a table up to this range of values
_BMP_HEADER = struct.Struct("<HIIIIiiHHIIiiII")  # file header + BITMAPINFOHEADER, 54 bytes
_THREADS = min(8, os.cpu_count() or 1)
_SPAN_MIN = 1 << 20  # values a thread takes at least


def _spans(n: int) -> list[tuple[int, int]]:
    """[lo, hi) spans that split range(n) among up to _THREADS threads."""
    k = max(1, min(_THREADS, n // _SPAN_MIN))
    b = [n * i // k for i in range(k + 1)]
    return list(zip(b[:-1], b[1:]))


def _each(fn, spans) -> list:
    """fn(lo, hi) for every span: on threads when there are several (numpy
    releases the GIL in the gathers, compares and parses used here)."""
    if len(spans) == 1:
        return [fn(*spans[0])]
    with ThreadPoolExecutor(len(spans)) as pool:
        return list(pool.map(lambda span: fn(*span), spans))


def _int_tokens(values: np.ndarray):
    """(``"%d, "`` of every value concatenated as uint8, each one's length),
    from a table over the values' range when it is narrow, else through
    Python's formatting."""
    lo, hi = int(values.min()), int(values.max())
    if hi - lo > _TABLE_SPAN:
        return _formatted_tokens("%d", values)
    text = [f"{v}, ".encode() for v in range(lo, hi + 1)]
    lens = np.fromiter(map(len, text), np.int64, len(text))
    words = 1 if lens.max() <= 8 else 2  # a token in one or two 8-byte words
    table = np.zeros((len(text), 8 * words), np.uint8)
    for i, t in enumerate(text):
        table[i, : len(t)] = np.frombuffer(t, np.uint8)
    table = table.view(np.uint64).reshape(-1, words)

    def span(a, b):
        idx = values[a:b].astype(np.int64) - lo if lo else values[a:b]
        rec = table[idx].view(np.uint8)
        return rec[rec != 0], lens[idx]

    parts = _each(span, _spans(values.size))
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])


def _formatted_tokens(fmt: str, values: np.ndarray):
    """(``fmt`` (the C writer's ``printf`` conversion) + ``", "`` of every
    value concatenated as uint8, each one's length): one Python format call
    over all of them."""
    text = (fmt + ", ") * values.size % tuple(values.tolist())
    stream = np.frombuffer(bytearray(text.encode()), np.uint8)
    return stream, np.diff(np.flatnonzero(stream == _SPACE), prepend=-1)


def _line_starts(c: np.ndarray) -> np.ndarray:
    """The tokens that begin a data line, where ``c[i]`` is the column at
    which token i starts, counting each token with its separator (comma and
    space; the last token without them). The C writer's greedy wrap: a line
    that starts at token s > 0 holds tokens s .. j while ``c[j + 1] - c[s]
    <= 62`` (columns 7 to 68); the first line, whose column count starts at
    0 after ``   data: [ ``, while ``c[j + 1] <= 69``. A line holds at
    least one token.

    Vectorized: ``nxt[s]``, the first token of the line after one that
    starts at s, for every s (a token's width bounds a line's count, so
    only the counts between those bounds are tested); the lines eight
    apart walked in Python through nxt applied eight times, the seven
    between them filled in by gathers."""
    n = c.size - 1
    budget = _WRAP - 6
    width = np.diff(c)
    lo = max(1, budget // int(width.max()))
    hi = max(lo, budget // int(width.min()))
    ix = np.int32 if c[-1] < 1 << 30 else np.int64
    cp = np.concatenate((c.astype(ix), np.full(hi + 1, np.iinfo(ix).max // 2, ix)))
    spans = _spans(n + 1)
    nxt = np.empty(n + 1, ix)

    def count(a, b):  # the lines' next first tokens, nxt[a:b]
        end = min(b, n)
        limit = cp[a:end] + budget
        k_ok = np.full(end - a, lo, ix)
        for k in range(lo + 1, hi + 1):
            k_ok += cp[a + k : end + k] <= limit
        k_ok += np.arange(a, end, dtype=ix)
        np.minimum(k_ok, n, out=nxt[a:end])
        nxt[end:b] = n

    _each(count, spans)
    jump = nxt
    for _ in range(3):  # nxt applied 2, 4, then 8 times
        src, jump = jump, np.empty_like(nxt)
        _each(lambda a, b: np.take(src, src[a:b], out=jump[a:b]), spans)
    at = memoryview(jump)
    i = max(1, int(np.searchsorted(c, _WRAP + 1, side="right")) - 1)
    first = []
    while i < n:
        first.append(i)
        i = at[i]
    lines = [np.asarray(first, ix)]
    for _ in range(7):
        lines.append(nxt[lines[-1]])
    starts = np.stack(lines, 1).ravel()
    return np.concatenate(([0], starts[starts < n]))


def write_yaml_mat(path, arr: np.ndarray, name: str = "mat") -> None:
    """Write a 2-D (rows, cols) or 3-D (rows, cols, channels) array of
    uint8, int16, int32, float32 or float64 as an OpenCV FileStorage YAML
    matrix named ``name``, byte for byte as the JAX package's C++ writer
    does. Vectorized: every token with its separator in one buffer (from a
    table for integers, one format call for floats), the lines' first
    tokens found from the tokens' widths, a line break where the space
    before each stood."""
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
    head = (f"%YAML:1.0\n---\nmat_name: {name}\ndata: !!opencv-matrix\n"
            f"   rows: {rows}\n   cols: {cols}\n"
            + (f'   dt: "{ch}{dt}"\n' if ch > 1 else f"   dt: {dt}\n") + "   data: [ ").encode()
    values = arr.ravel()
    body = b""
    if values.size:
        stream, lens = (_formatted_tokens(_TOKEN[dt], values) if dt in _TOKEN
                        else _int_tokens(values))
        c = np.zeros(values.size + 1, np.int64)
        np.cumsum(lens, out=c[1:])
        c[-1] -= 1  # the last token has no comma
        stream[c[_line_starts(c)[1:]] - 1] = _NEWLINE  # the space before a line's first token
        body = stream[: c[-1] - 1].tobytes().replace(b"\n", b"\n" + b" " * 7)
    with open(path, "wb") as f:
        f.write(head + body + b" ]\n")


def _field(head: str, key: str) -> str:
    """The value of ``key:`` at the start of a line (after indentation)."""
    m = re.search(rf"^[ \t]*{key}:[ \t]*(.*)$", head, re.MULTILINE)
    if m is None:
        raise ValueError(f"missing {key}:")
    return m.group(1).strip().strip('"')


def read_yaml_mat(path) -> np.ndarray:
    """Read an OpenCV FileStorage YAML matrix -> (rows, cols) or (rows,
    cols, channels) ndarray, as the JAX package's C++ reader does: the
    first rows * cols * channels values of the data block (fewer raise),
    integers wrapped to the element type. numpy parses the data block, in
    pieces split at commas, one a thread. Raises ValueError on a malformed
    file."""
    with open(path, "rb") as f:
        raw = f.read()
    m = re.search(rb"^[ \t]*data:", raw, re.MULTILINE)
    bracket = raw.find(b"[", m.end()) if m else -1
    head = raw[: bracket if bracket >= 0 else len(raw)].decode("utf-8", "replace")
    try:
        rows, cols = int(_field(head, "rows")), int(_field(head, "cols"))
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    spec = re.fullmatch(r"(\d*)([usifd])", _field(head, "dt"))
    if spec is None:
        raise ValueError(f"{path}: unsupported dt {_field(head, 'dt')!r}")
    ch, dt = int(spec.group(1) or 1), spec.group(2)
    n = rows * cols * ch
    if rows <= 0 or cols <= 0 or ch <= 0 or n > 1 << 33:
        raise ValueError(f"{path}: bad matrix dimensions {rows}x{cols}x{ch}")
    if bracket < 0:
        raise ValueError(f"{path}: missing data [")
    start, stop = bracket + 1, raw.find(b"]", bracket)
    stop = stop if stop >= 0 else len(raw)
    cuts = [start]  # the block in pieces, one a thread, split where a comma stands
    for lo, _ in _spans(n)[1:]:
        comma = raw.find(b",", max(start + (stop - start) * lo // n, cuts[-1]), stop)
        if comma < 0:
            break
        cuts.append(comma + 1)
    pieces = list(zip(cuts, [c - 1 for c in cuts[1:]] + [stop]))
    wide = np.float64 if dt in "fd" else np.int64
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)  # a token numpy cannot parse
        try:
            flat = np.concatenate(_each(lambda a, b: np.fromstring(raw[a:b], wide, sep=","),
                                        pieces))
        except (DeprecationWarning, ValueError) as e:
            raise ValueError(f"{path}: unparsable data: {e}") from None
    if flat.size < n:
        raise ValueError(f"{path}: data too short, {flat.size} values for {rows}x{cols}x{ch}")
    arr = flat[:n].astype(_DT[dt])
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
    """Read an uncompressed 24-bit BMP -> (H, W, 3) uint8 BGR, top row first.
    Raises ValueError on a file that is not one, or is cut short."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < _BMP_HEADER.size:
        raise ValueError(f"{path}: {len(raw)} bytes, shorter than a BMP header")
    (magic, _, _, offset, _, w, h, _, bpp, compression, *_) = _BMP_HEADER.unpack_from(raw)
    if magic != 0x4D42 or bpp != 24 or compression != 0 or w < 0:
        raise ValueError(f"{path}: not an uncompressed 24-bit BMP")
    rows, row_bytes = abs(h), (3 * w + 3) & ~3
    if len(raw) < offset + rows * row_bytes:
        raise ValueError(f"{path}: truncated, {len(raw)} bytes for {rows} rows of "
                         f"{row_bytes} from byte {offset}")
    body = np.frombuffer(raw, np.uint8, rows * row_bytes, offset).reshape(rows, row_bytes)
    img = body[:, : 3 * w].reshape(rows, w, 3)
    return (img[::-1] if h > 0 else img).copy()


def prep_mask(mask: np.ndarray):
    """Binarize + 1-px border zero + bbox (the JAX package's
    ``native.prep_mask``; the reference's setMaskBoundaryToConstant and
    calBoundingBox, seamlessClone_imp.cpp:927-1012).

    Any nonzero value is inside (a non-uint8 mask is compared with 0 before
    any cast: 0.5 and 256 count). Returns (prepared (H, W) uint8 {0, 255},
    (x0, y0, bw, bh)); bw == 0 for an empty mask. Equal to
    ``zero_mask_border`` of the {0, 255} mask and its ``mask_bounding_box``
    (``core/reference.py``), with the bbox from the rows and columns that
    hold a pixel instead of index arrays of every pixel.
    """
    mask = np.asarray(mask)
    out = np.zeros(mask.shape, np.uint8)
    inside = mask[1:-1, 1:-1] != 0
    np.multiply(inside, np.uint8(255), out=out[1:-1, 1:-1])
    rows = np.flatnonzero(inside.any(axis=1))
    if rows.size == 0:
        return out, (0, 0, 0, 0)
    cols = np.flatnonzero(inside.any(axis=0))
    return out, (int(cols[0]) + 1, int(rows[0]) + 1, int(cols[-1] - cols[0]) + 1,
                 int(rows[-1] - rows[0]) + 1)


__all__ = ["read_yaml_mat", "write_yaml_mat", "write_bmp", "read_bmp", "prep_mask"]
