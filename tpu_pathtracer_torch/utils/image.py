"""Image I/O: an 8-bit PNG codec, PPM, a self-contained OpenEXR codec, and
the procedural HDR environment.  Counterpart of `tpu_pathtracer/utils/image.py`,
in numpy and `zlib` alone: the JAX package reads and writes PNG through
PIL, which the port does not need.

PNG scope: decode 8-bit, non-interlaced images of colour types 0 (grey),
2 (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA) under all five row
filters, to RGB as PIL's `Image.open(path).convert("RGB")` gives it (grey
replicated, palette looked up, alpha dropped); encode 8-bit RGB.  Any
other PNG (16-bit, fewer than 8 bits a sample, interlaced) raises a
ValueError naming the file.  PPM scope: read binary P6 (RGB) and P5
(grey) with a maxval of 255; write P6.

EXR scope (from the public OpenEXR 2.0 file format specification):
scanline images, NO_COMPRESSION / ZIPS / ZIP (zlib + delta-predictor +
two-half deinterleave), HALF / FLOAT / UINT channels.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# PNG (8-bit) in numpy + zlib
# ---------------------------------------------------------------------------

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# colour type: samples a pixel
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_UP = 2  # the row filter the encoder writes


def _png_chunks(buf: bytes, path: str):
    """(type, payload) of every chunk, CRCs checked."""
    off = len(_PNG_MAGIC)
    while off + 8 <= len(buf):
        (length,) = struct.unpack_from(">I", buf, off)
        ctype = buf[off + 4 : off + 8]
        payload = buf[off + 8 : off + 8 + length]
        (crc,) = struct.unpack_from(">I", buf, off + 8 + length)
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"{path}: PNG chunk {ctype!r} fails its CRC")
        yield ctype, payload
        off += 12 + length
        if ctype == b"IEND":
            return
    raise ValueError(f"{path}: PNG ends without IEND")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor on int16 arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(filtered: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """[H,W,C] filtered bytes, [H] filter types 0-4 -> [H,W,C] uint8.

    Rows of types None, Sub and Up are undone one row at a time, each row
    at once (Sub is a running sum along x).  Average and Paeth make a
    pixel depend on its left neighbour through a non-linear predictor, so
    when any row uses them the whole image is undone along anti-diagonals
    x + y = d: every pixel of a diagonal depends only on the two before it
    (left, up, upper-left), so each diagonal is one array step."""
    h, w, ch = filtered.shape
    if not np.isin(kinds, (3, 4)).any():
        out = np.empty_like(filtered)
        prev = np.zeros((w, ch), np.uint8)
        for y in range(h):
            row, kind = filtered[y], kinds[y]
            if kind == 1:
                row = np.add.accumulate(row, axis=0, dtype=np.uint8)
            elif kind == 2:
                row = row + prev
            out[y] = row
            prev = out[y]
        return out
    # Skewed layout: s[y + 1, x + y + 2] = pixel (y, x); row 0 and
    # columns 0-1 are the zero border.  Diagonal d = x + y is column d + 2,
    # its left neighbours column d + 1 (same row), its up neighbours column
    # d + 1 (row above), its upper-left ones column d (row above).
    # Positions left of x = 0 stay zero (their inputs are all zero).
    ys = np.arange(h)[:, None]
    cols = ys + np.arange(w)[None, :] + 2
    f = np.zeros((h, w + h + 2, ch), np.int16)
    f[ys, cols] = filtered
    s = np.zeros((h + 1, w + h + 2, ch), np.int16)
    kind = kinds.astype(np.int16)[:, None]
    for c in range(2, w + h + 1):
        left, up, ul = s[1:, c - 1], s[:-1, c - 1], s[:-1, c - 2]
        pred = np.select(
            [kind == 1, kind == 2, kind == 3, kind == 4],
            [left, up, (left + up) >> 1, _paeth(left, up, ul)],
            0,
        )
        s[1:, c] = (f[:, c] + pred) & 0xFF
    return s[ys + 1, cols].astype(np.uint8)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> [H,W,3] uint8 (row 0 = top), as PIL's convert("RGB")."""
    if not data.startswith(_PNG_MAGIC):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for ctype, payload in _png_chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {color}, interlace {interlace}): "
            "only 8-bit, non-interlaced grey, RGB, palette, grey+alpha and RGBA images are read"
        )
    ch = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError(f"{path}: PNG image data has {raw.size} bytes, not {h * (1 + w * ch)}")
    rows = raw.reshape(h, 1 + w * ch)
    kinds = rows[:, 0]
    if (kinds > 4).any():
        raise ValueError(f"{path}: PNG row filter {int(kinds.max())} is not one of 0-4")
    px = _unfilter_rows(rows[:, 1:].reshape(h, w, ch), kinds)
    if color == 3:
        if palette is None or int(px.max()) >= len(palette):
            raise ValueError(f"{path}: PNG palette index out of range")
        return palette[px[..., 0]]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def encode_png(rgb_u8: np.ndarray, level: int = 6) -> bytes:
    """[H,W,3] uint8 (row 0 = top) -> PNG bytes: 8-bit RGB, every row
    filtered Up (its difference to the row above)."""
    img = np.ascontiguousarray(rgb_u8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png wants [H,W,3] uint8, got {img.shape}")
    h, w, _ = img.shape
    up = img.copy()
    up[1:] -= img[:-1]  # uint8 arithmetic wraps mod 256
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = _PNG_UP
    rows[:, 1:] = up.reshape(h, 3 * w)

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", zlib.crc32(ctype + payload))

    return b"".join([
        _PNG_MAGIC,
        chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        chunk(b"IDAT", zlib.compress(rows.tobytes(), level)),
        chunk(b"IEND", b""),
    ])


def load_png(path: str) -> np.ndarray:
    """[H,W,3] uint8 RGB of an 8-bit PNG file."""
    with open(path, "rb") as f:
        return decode_png(f.read(), str(path))


def decode_ppm(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Binary PPM (P6) or PGM (P5) bytes with a maxval of 255 -> [H,W,3]
    uint8 (row 0 = top), as PIL's convert("RGB") (grey replicated)."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.find(b"\n", pos) + 1 or len(data)
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace() and data[pos:pos + 1] != b"#":
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: truncated PPM header")
        fields.append(data[start:pos])
    if not all(f.isdigit() for f in fields) or int(fields[2]) != 255:
        raise ValueError(f"{path}: unsupported PPM header {b' '.join(fields)!r}: only 8-bit (maxval 255) is read")
    w, h = int(fields[0]), int(fields[1])
    ch = 3 if data.startswith(b"P6") else 1
    body = data[pos + 1:pos + 1 + h * w * ch]  # one whitespace byte ends the header
    if len(body) != h * w * ch:
        raise ValueError(f"{path}: PPM image data shorter than {w}x{h}x{ch} bytes")
    px = np.frombuffer(body, np.uint8).reshape(h, w, ch)
    return np.repeat(px, 3, axis=-1) if ch == 1 else px.copy()


def load_image(path: str) -> np.ndarray:
    """Load a PNG or a binary PPM/PGM, told apart by their first bytes
    (float32 [H,W,3] in [0,1]: u8/255, as the reference's texture
    conversion), or an EXR (load_exr); anything else raises."""
    if str(path).lower().endswith(".exr"):
        return load_exr(path)
    with open(path, "rb") as f:
        data = f.read()
    rgb = decode_ppm(data, str(path)) if data[:2] in (b"P5", b"P6") else decode_png(data, str(path))
    return np.asarray(rgb, dtype=np.float32) / 255.0


def save_png(path: str, rgb_u8: np.ndarray) -> None:
    """Save [H,W,3] uint8 (row 0 = top)."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb_u8))


def save_ppm(path: str, rgb_u8: np.ndarray) -> None:
    h, w = rgb_u8.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgb_u8).tobytes())


def save_image(path: str, rgb_u8: np.ndarray) -> None:
    """PNG, PPM or EXR by extension."""
    p = str(path).lower()
    if p.endswith(".ppm"):
        save_ppm(path, rgb_u8)
    elif p.endswith(".exr"):
        save_exr(path, rgb_u8.astype(np.float32))
    else:
        save_png(path, rgb_u8)


# ---------------------------------------------------------------------------
# OpenEXR scanline codec (subset: what HDR environment maps actually use)
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PT_BYTES = {_PT_UINT: 4, _PT_HALF: 2, _PT_FLOAT: 4}
_PT_DTYPE = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}
# compression ids
_NO_COMP, _RLE, _ZIPS, _ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_NO_COMP: 1, _ZIPS: 1, _ZIP: 16}


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin-1"), end + 1


def _exr_unpredict(data: bytes) -> bytes:
    """Invert ZIP post-deflate transform: delta-decode, then deinterleave."""
    arr = np.frombuffer(data, np.uint8).astype(np.int16)
    # delta decode: d[i] += d[i-1] - 128 (sequential; use cumsum)
    deltas = arr.copy()
    deltas[1:] = (arr[1:] - 128).astype(np.int16)
    out = np.cumsum(deltas, dtype=np.int64).astype(np.uint8)
    # deinterleave: first half -> even bytes, second half -> odd bytes
    n = len(out)
    half = (n + 1) // 2
    result = np.empty(n, np.uint8)
    result[0::2] = out[:half]
    result[1::2] = out[half:]
    return result.tobytes()


def _exr_predict(data: bytes) -> bytes:
    """Forward ZIP pre-deflate transform (interleave + delta-encode)."""
    arr = np.frombuffer(data, np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    out = inter.astype(np.int16)
    out[1:] = (inter[1:].astype(np.int16) - inter[:-1].astype(np.int16) + 128)
    return out.astype(np.uint8).tobytes()


def load_exr(path: str) -> np.ndarray:
    """Read a scanline EXR; returns float32 [H,W,3] (R,G,B; missing channels
    filled with the luminance channel or zeros)."""
    with open(path, "rb") as f:
        buf = f.read()

    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    off = 8

    # --- parse header attributes ---
    channels = []  # list of (name, pixel_type)
    compression = _NO_COMP
    data_window = None
    while True:
        name, off = _read_cstr(buf, off)
        if name == "":
            break
        atype, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        payload = buf[off : off + size]
        off += size
        if name == "channels" and atype == "chlist":
            p = 0
            while payload[p] != 0:
                cname, p = _read_cstr(payload, p)
                # entry: pixelType i32, pLinear u8 + 3 reserved, xSampling
                # i32, ySampling i32 = 16 bytes
                (ptype,) = struct.unpack_from("<i", payload, p)
                p += 16
                channels.append((cname, ptype))
            # chlist is stored alphabetically already, but be safe:
            channels.sort(key=lambda c: c[0])
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)

    if data_window is None or not channels:
        raise ValueError(f"{path}: missing required EXR attributes")
    if compression not in _LINES_PER_BLOCK:
        raise ValueError(f"{path}: unsupported EXR compression {compression}")

    xmin, ymin, xmax, ymax = data_window
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    lines_per_block = _LINES_PER_BLOCK[compression]
    num_blocks = (height + lines_per_block - 1) // lines_per_block

    # --- scanline offset table ---
    offsets = struct.unpack_from("<%dQ" % num_blocks, buf, off)

    per_line_bytes = sum(width * _PT_BYTES[pt] for _, pt in channels)
    chan_data: Dict[str, np.ndarray] = {
        cname: np.zeros((height, width), np.float32) for cname, _ in channels
    }

    for block_off in offsets:
        y, size = struct.unpack_from("<ii", buf, block_off)
        raw = buf[block_off + 8 : block_off + 8 + size]
        n_lines = min(lines_per_block, ymax - y + 1)
        expect = per_line_bytes * n_lines
        if compression in (_ZIPS, _ZIP):
            if size < expect:  # compressed only when it helps (spec)
                raw = _exr_unpredict(zlib.decompress(raw))
        p = 0
        for line in range(n_lines):
            yy = y - ymin + line
            for cname, ptype in channels:
                nbytes = width * _PT_BYTES[ptype]
                vals = np.frombuffer(raw, _PT_DTYPE[ptype], count=width, offset=p)
                chan_data[cname][yy] = vals.astype(np.float32)
                p += nbytes

    def pick(*names):
        for n in names:
            if n in chan_data:
                return chan_data[n]
        return None

    r = pick("R", "Y")
    g = pick("G", "Y")
    b = pick("B", "Y")
    zero = np.zeros((height, width), np.float32)
    return np.stack([x if x is not None else zero for x in (r, g, b)], axis=-1)


def save_exr(path: str, rgb: np.ndarray, compression: int = _ZIP) -> None:
    """Write float32 [H,W,3] as scanline EXR (FLOAT channels, ZIP)."""
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]

    def attr(name: str, atype: str, payload: bytes) -> bytes:
        return (
            name.encode() + b"\x00" + atype.encode() + b"\x00"
            + struct.pack("<i", len(payload)) + payload
        )

    # channels: B, G, R (alphabetical), FLOAT
    chlist = b""
    for cname in (b"B", b"G", b"R"):
        # pixelType i32, pLinear u8 + 3 reserved, xSampling i32, ySampling i32
        chlist += cname + b"\x00" + struct.pack("<i4Bii", _PT_FLOAT, 0, 0, 0, 0, 1, 1)
    chlist += b"\x00"

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b""
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", bytes([compression]))
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    lines_per_block = _LINES_PER_BLOCK[compression]
    num_blocks = (h + lines_per_block - 1) // lines_per_block

    blocks = []
    for bi in range(num_blocks):
        y0 = bi * lines_per_block
        n_lines = min(lines_per_block, h - y0)
        parts = []
        for line in range(n_lines):
            row = rgb[y0 + line]
            for ci in (2, 1, 0):  # B, G, R order
                parts.append(row[:, ci].astype("<f4").tobytes())
        raw = b"".join(parts)
        if compression in (_ZIPS, _ZIP):
            comp = zlib.compress(_exr_predict(raw))
            data = comp if len(comp) < len(raw) else raw
        else:
            data = raw
        blocks.append((y0, data))

    base = 8 + len(header) + 8 * num_blocks
    out = [struct.pack("<ii", _EXR_MAGIC, 2), header]
    offsets = []
    pos = base
    for y0, data in blocks:
        offsets.append(pos)
        pos += 8 + len(data)
    out.append(struct.pack("<%dQ" % num_blocks, *offsets))
    for y0, data in blocks:
        out.append(struct.pack("<ii", y0, len(data)))
        out.append(data)
    with open(path, "wb") as f:
        f.write(b"".join(out))


# ---------------------------------------------------------------------------
# Procedural HDR environment
# ---------------------------------------------------------------------------


def procedural_hdr(
    height: int = 256,
    width: int = 512,
    sun_dir=(0.0, 2.0, 3.0),
    sun_intensity: float = 200.0,
    seed: int = 0,
) -> np.ndarray:
    """Synthesize an equirect HDR [H,W,3] f32: gradient sky, warm sun disc
    and glow, ground below the horizon, 2% multiplicative noise."""
    v, u = np.meshgrid(
        (np.arange(height) + 0.5) / height,
        (np.arange(width) + 0.5) / width,
        indexing="ij",
    )
    phi = (u - 0.5) * 2.0 * np.pi
    theta = (0.5 - v) * np.pi
    y = np.sin(theta)
    c = np.cos(theta)
    dirs = np.stack([c * np.cos(phi), y, c * np.sin(phi)], axis=-1)

    sd = np.asarray(sun_dir, np.float64)
    sd = sd / np.linalg.norm(sd)
    cos_sun = dirs @ sd

    horizon = np.array([0.55, 0.6, 0.7])
    zenith = np.array([0.15, 0.25, 0.5])
    tsky = np.clip(y, 0.0, 1.0)[..., None]
    sky = horizon + (zenith - horizon) * tsky
    ground = np.array([0.25, 0.2, 0.15]) * (1.0 + 0.3 * np.clip(-y, 0, 1))[..., None]
    img = np.where(y[..., None] >= 0.0, sky, ground)

    sun_col = np.array([1.0, 0.875, 0.625]) * sun_intensity
    disc = np.clip((cos_sun - 0.995) / 0.005, 0.0, 1.0) ** 2
    img = img + disc[..., None] * sun_col
    glow = np.clip(cos_sun, 0.0, 1.0) ** 32
    img = img + glow[..., None] * np.array([1.5, 1.0, 0.5])

    rs = np.random.RandomState(seed)
    img *= 1.0 + 0.02 * rs.randn(height, width, 1)
    return np.maximum(img, 0.0).astype(np.float32)
