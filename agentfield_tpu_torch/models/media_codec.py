"""Image codecs of the node, over the standard library and numpy: the part
of Pillow the JAX node uses (``Image.open(...).convert("RGB").resize(...)``
and ``Image.save(format="PNG")``), which the card's machine does not have.

- ``decode_png``: colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey +
  alpha) and 6 (RGBA) at 8 bits a sample, grey and palette also at 1, 2
  and 4 (Pillow writes bilevel images and palettes of up to 16 colours so);
  plain or Adam7 interlaced; all five row filters, undone along
  anti-diagonals, so every step is one numpy operation over independent
  pixels. Alpha is dropped, as ``convert("RGB")`` drops it. 16-bit PNG
  raises ValueError.
- ``encode_png``: 8-bit RGB, a filter a row by libpng's least-sum rule (so
  None, Sub, Up, Average and Paeth rows, as clients' PNGs hold), zlib. Its
  bytes may differ from Pillow's; the pixels are the same.
- ``decode_jpeg``: baseline Huffman JPEG, 8-bit, 1 or 3 components in one
  interleaved scan, any sampling factors, restart markers. It computes
  what libjpeg(-turbo) computes with Pillow's settings: the ``islow``
  integer IDCT, "fancy" triangle upsampling of 4:2:2, 4:2:0 and 4:4:0
  chroma, and the fixed-point YCbCr→RGB tables. Extended sequential,
  progressive, lossless, hierarchical and arithmetic-coded JPEGs, and
  colour in one scan per component, raise ValueError naming the format.
- ``encode_jpeg``: a baseline JPEG (the standard tables scaled by quality as
  libjpeg scales them, 4:4:4, 4:2:2 or 4:2:0).
- ``resize_bicubic``: Pillow's ``Image.resize`` default for RGB — a
  separable two-pass convolution (horizontal first) with the bicubic
  kernel (a = -0.5), its support widened by the reduction factor, 22-bit
  fixed-point coefficients and a uint8 clip after each pass.

``decode_image`` picks PNG or JPEG by the file's signature. Every decoder
returns ``[H, W, 3]`` uint8.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

PNG_SIG = b"\x89PNG\r\n\x1a\n"
JPEG_SIG = b"\xff\xd8"


def decode_image(data: bytes) -> np.ndarray:
    """PNG or JPEG bytes → [H, W, 3] uint8."""
    if data[:8] == PNG_SIG:
        return decode_png(data)
    if data[:2] == JPEG_SIG:
        return decode_jpeg(data)
    raise ValueError("not a PNG or JPEG image (unknown signature)")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (x start, y start, x step, y step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


# the most bytes the skewed copy of ``_unfilter`` may take: a band of rows
# at a time, so a tall image costs a few bands and not (h + w) x h cells
UNFILTER_BAND_BYTES = 1 << 26


def _unfilter(raw: bytes, off: int, units: int, h: int, bpp: int) -> tuple[np.ndarray, int]:
    """Undo the row filters of ``h`` rows of ``units`` filter units of
    ``bpp`` bytes starting at ``raw[off]``; returns ([h, units * bpp]
    uint8, the offset past them). Unit (y, x) depends on (y, x-1), (y-1, x)
    and (y-1, x-1) only, so the units of one anti-diagonal y + x = t are
    reconstructed together. A band of ``hb`` rows is held skewed,
    ``sk[t + 2, y + 1]`` = unit (y, t - y), so that a diagonal and its two
    predecessors are contiguous slices; row 0 holds the row above the band
    (zeros above the image), two zero diagonals come first."""
    stride = units * bpp
    n = h * (stride + 1)
    if off + n > len(raw):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, n, off).reshape(h, stride + 1)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"PNG row filter {int(ftype.max())} is not a PNG filter")
    filt = rows[:, 1:].reshape(h, units, bpp)
    cells = UNFILTER_BAND_BYTES // (2 * bpp)  # (hb + units) * hb int16 cells at most
    band = max(1, (math.isqrt(units * units + 4 * cells) - units) // 2)
    out = np.empty((h, units, bpp), np.uint8)
    above = np.zeros((units, bpp), np.int16)
    for y0 in range(0, h, band):
        hb = min(band, h - y0)
        ys, xs = np.indices((hb, units))
        sk = np.zeros((hb + units + 1, hb + 1, bpp), np.int16)
        sk[1:units + 1, 0] = above
        sk[ys + xs + 2, ys + 1] = filt[y0:y0 + hb]
        kind = [(ftype[y0:y0 + hb] == k)[:, None] for k in (1, 2, 3, 4)]
        for t in range(hb + units - 1):
            lo, hi = max(0, t - units + 1), min(hb - 1, t) + 1  # the rows diagonal t crosses
            a, b, c = sk[t + 1, lo + 1:hi + 1], sk[t + 1, lo:hi], sk[t, lo:hi]  # left, up, up-left
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            k1, k2, k3, k4 = (m[lo:hi] for m in kind)
            pred = np.where(k4, paeth, np.where(k3, (a + b) >> 1, np.where(k2, b,
                                                                          np.where(k1, a, 0))))
            cur = sk[t + 2, lo + 1:hi + 1]
            cur += pred
            cur &= 255
        out[y0:y0 + hb] = sk[ys + xs + 2, ys + 1]
        above = out[y0 + hb - 1].astype(np.int16)
    return out.reshape(h, stride), off + n


def _samples(rows: np.ndarray, w: int, depth: int, c: int) -> np.ndarray:
    """Unfiltered rows [h, bytes] → samples [h, w, c] (a sub-byte depth
    unpacked, most significant bits first)."""
    if depth == 8:
        return rows[:, : w * c].reshape(len(rows), w, c)
    bits = np.unpackbits(rows, axis=1).reshape(len(rows), -1, depth).astype(np.int32)
    vals = (bits << np.arange(depth - 1, -1, -1)).sum(axis=2)
    return vals[:, :w, None].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → [H, W, 3] uint8 (see the module docstring)."""
    if data[:8] != PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos + 8 <= len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[: len(body) // 3 * 3].reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not a PNG colour type")
    if depth == 16:
        raise ValueError("16-bit PNG is not supported (PNG of 1, 2, 4 or 8 bits a sample)")
    if depth not in (1, 2, 4, 8) or (depth < 8 and ctype not in (0, 3)):
        raise ValueError(f"PNG colour type {ctype} at bit depth {depth} is not a PNG format")
    c = _PNG_CHANNELS[ctype]
    bpp = max(1, depth * c // 8)  # the filters' byte distance

    def units(pw: int) -> int:  # filter units of a row of pw pixels
        return -(-pw * depth * c // 8) // bpp

    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from e
    if interlace == 0:
        rows, _ = _unfilter(raw, 0, units(w), h, bpp)
        px = _samples(rows, w, depth, c)
    elif interlace == 1:
        px = np.zeros((h, w, c), np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:
                rows, off = _unfilter(raw, off, units(pw), ph, bpp)
                px[y0::dy, x0::dx] = _samples(rows, pw, depth, c)
    else:
        raise ValueError(f"PNG interlace method {interlace} is not a PNG interlace method")
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        pal = np.zeros((256, 3), np.uint8)
        pal[: len(palette)] = palette[:256]
        return pal[px[..., 0]]
    if ctype in (0, 4):
        grey = px[..., :1] * np.uint8(255 // ((1 << depth) - 1))  # a sub-byte grey to 0..255
        return np.repeat(grey, 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray) -> bytes:
    """[H, W, 3] uint8 → 8-bit RGB PNG bytes, each row's filter chosen as
    libpng chooses it: the least sum of the filtered bytes read as signed,
    the first filter on a tie."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes [H, W, 3] uint8, got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)  # left, up, up-left
    a[:, 3:], b[1:], c[1:, 3:] = x[:, :-3], x[:-1], x[:-1, :-3]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]) & 255  # [5, h, w * 3]
    ftype = np.minimum(cand, 256 - cand).sum(axis=2).argmin(axis=0)
    rows = np.concatenate([ftype[:, None], cand[ftype, np.arange(h)]], axis=1).astype(np.uint8)
    return (PNG_SIG + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _png_chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------


def _zigzag() -> np.ndarray:
    """ZIGZAG[k] = the natural (row-major) index of zigzag position k."""
    order = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda rc: (rc[0] + rc[1], rc[1] if (rc[0] + rc[1]) % 2 == 0 else rc[0]))
    return np.array([r * 8 + c for r, c in order], np.int64)


ZIGZAG = _zigzag()
_SOF_NAMES = {0xC1: "extended sequential", 0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
              0xC6: "differential progressive", 0xC7: "differential lossless",
              0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential",
              0xCE: "arithmetic-coded differential progressive",
              0xCF: "arithmetic-coded differential lossless"}


def _huff_lut(counts: bytes, symbols: bytes) -> list[int]:
    """A 16-bit lookup: the next 16 bits → (code length << 8) | symbol;
    0 where no code matches."""
    lut = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo: lo + (1 << (16 - length))] = [(length << 8) | symbols[k]] * (1 << (16 - length))
            code += 1
            k += 1
        code <<= 1
    return lut


def _scan_intervals(data: bytes, pos: int) -> tuple[list[bytes], int]:
    """The entropy-coded data from ``pos``, cut at restart markers and
    unstuffed; returns (intervals, the offset of the marker that ends it)."""
    out, start, i = [], pos, pos
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= len(data):
            out.append(data[start:].replace(b"\xff\x00", b"\xff"))
            return out, len(data)
        m = data[i + 1]
        if m == 0x00 or m == 0xFF:
            i += 1
        elif 0xD0 <= m <= 0xD7:
            out.append(data[start:i].replace(b"\xff\x00", b"\xff"))
            i += 2
            start = i
        else:
            out.append(data[start:i].replace(b"\xff\x00", b"\xff"))
            return out, i


def _decode_scan(intervals, comps, mcus, ri, nb_x, coefs):
    """Huffman-decode one scan into ``coefs`` (per component, the flat
    indexes and values of its nonzero coefficients, natural order).
    ``comps``: per scan component (id, blocks of one MCU across, down, dc
    lut, ac lut); ``mcus``: the MCU grid (rows, cols); ``nb_x``: each
    component's block columns."""
    zz = ZIGZAG.tolist()
    n_mcu = mcus[0] * mcus[1]
    per = ri if ri else n_mcu
    pred = {c[0]: 0 for c in comps}
    buf = b""
    i = acc = nb = 0
    for m in range(n_mcu):
        if m % per == 0:
            k_int = m // per
            if k_int >= len(intervals):
                raise ValueError("JPEG scan ends before its last MCU")
            buf = intervals[k_int] + b"\0\0\0\0"
            i = acc = nb = 0
            for cid in pred:
                pred[cid] = 0
        my, mx = divmod(m, mcus[1])
        for cid, hs, vs, dc, ac in comps:
            pos_l, val_l = coefs[cid]
            for b in range(hs * vs):
                oy, ox = divmod(b, hs)
                base = ((my * vs + oy) * nb_x[cid] + mx * hs + ox) * 64
                # DC
                while nb < 16:
                    acc = ((acc & 0xFFFF) << 8) | buf[i]
                    i += 1
                    nb += 8
                code = dc[(acc >> (nb - 16)) & 0xFFFF]
                if not code:
                    raise ValueError("JPEG data holds an invalid Huffman code")
                nb -= code >> 8
                s = code & 255
                if s:
                    while nb < s:
                        acc = ((acc & 0xFFFF) << 8) | buf[i]
                        i += 1
                        nb += 8
                    v = (acc >> (nb - s)) & ((1 << s) - 1)
                    nb -= s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    pred[cid] += v
                pos_l.append(base)
                val_l.append(pred[cid])
                # AC
                k = 1
                while k < 64:
                    while nb < 16:
                        acc = ((acc & 0xFFFF) << 8) | buf[i]
                        i += 1
                        nb += 8
                    code = ac[(acc >> (nb - 16)) & 0xFFFF]
                    if not code:
                        raise ValueError("JPEG data holds an invalid Huffman code")
                    nb -= code >> 8
                    s = code & 15
                    r = (code & 255) >> 4
                    if s:
                        k += r
                        if k > 63:
                            raise ValueError("JPEG block overruns 64 coefficients")
                        while nb < s:
                            acc = ((acc & 0xFFFF) << 8) | buf[i]
                            i += 1
                            nb += 8
                        v = (acc >> (nb - s)) & ((1 << s) - 1)
                        nb -= s
                        if v < (1 << (s - 1)):
                            v -= (1 << s) - 1
                        pos_l.append(base + zz[k])
                        val_l.append(v)
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        break


# libjpeg's jidctint.c constants (CONST_BITS 13)
_C = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270,
      "0_899976223": 7373, "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137,
      "1_961570560": 16069, "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _idct_1d(v, shift: int):
    """One pass of libjpeg's ``jpeg_idct_islow`` over the last axis (8
    values), descaled by ``shift`` bits with rounding; int64 arrays."""
    z2, z3 = v[..., 2], v[..., 6]
    z1 = (z2 + z3) * _C["0_541196100"]
    tmp2 = z1 + z3 * -_C["1_847759065"]
    tmp3 = z1 + z2 * _C["0_765366865"]
    tmp0 = (v[..., 0] + v[..., 4]) << 13
    tmp1 = (v[..., 0] - v[..., 4]) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = v[..., 7], v[..., 5], v[..., 3], v[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _C["1_175875602"]
    t0 = t0 * _C["0_298631336"]
    t1 = t1 * _C["2_053119869"]
    t2 = t2 * _C["3_072711026"]
    t3 = t3 * _C["1_501321110"]
    z1 = z1 * -_C["0_899976223"]
    z2 = z2 * -_C["2_562915447"]
    z3 = z3 * -_C["1_961570560"] + z5
    z4 = z4 * -_C["0_390180644"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    rnd = 1 << (shift - 1)
    return np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], axis=-1) + rnd >> shift


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantized coefficients [..., 8, 8] (natural order) → samples
    [..., 8, 8] uint8, as libjpeg's ``islow`` IDCT and its range limit."""
    ws = _idct_1d(np.swapaxes(coef.astype(np.int64), -1, -2), 13 - 2)  # columns, PASS1_BITS 2
    out = _idct_1d(np.swapaxes(ws, -1, -2), 13 + 2 + 3)  # rows
    wrapped = ((out & 1023) ^ 512) - 512  # libjpeg's RANGE_MASK table lookup
    return np.clip(wrapped + 128, 0, 255).astype(np.uint8)


def _fancy_h2(x: np.ndarray) -> np.ndarray:
    """libjpeg's h2v1 fancy upsampling of rows ``x`` [h, w] (int)."""
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int64)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    out[:, 0], out[:, -1] = x[:, 0], x[:, -1]
    return out


def _colsums(x: np.ndarray) -> np.ndarray:
    """3 x nearer row + the row above (even output rows) / below (odd),
    the edge rows replicated, as libjpeg's context rows are."""
    above = np.concatenate([x[:1], x[:-1]])
    below = np.concatenate([x[1:], x[-1:]])
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int64)
    out[0::2], out[1::2] = 3 * x + above, 3 * x + below
    return out


def _upsample(plane: np.ndarray, hx: int, vx: int) -> np.ndarray:
    """Chroma plane [dh, dw] (its real samples) upsampled by (hx, vx) the
    way libjpeg(-turbo) does with ``do_fancy_upsampling``."""
    x = plane.astype(np.int64)
    w = x.shape[1]
    if (hx, vx) == (1, 1):
        return x
    if (hx, vx) == (2, 1) and w > 2:
        return _fancy_h2(x)
    if (hx, vx) == (2, 2) and w > 2:
        cs = _colsums(x)
        out = np.empty((cs.shape[0], 2 * w), np.int64)
        left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        out[:, 0::2] = (3 * cs + left + 8) >> 4
        out[:, 1::2] = (3 * cs + right + 7) >> 4
        out[:, 0] = (4 * cs[:, 0] + 8) >> 4
        out[:, -1] = (4 * cs[:, -1] + 7) >> 4
        return out
    if (hx, vx) == (1, 2):
        return (_colsums(x) + np.tile([1, 2], x.shape[0])[:, None]) >> 2
    return np.repeat(np.repeat(x, vx, axis=0), hx, axis=1)  # box replication


def _ycc_tables():
    """libjpeg's jdcolor.c tables (SCALEBITS 16), indexed by Cb/Cr."""
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's fixed-point YCbCr → RGB of uint8-valued planes."""
    y = y.astype(np.int64)
    cb, cr = cb.astype(np.int64), cr.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """Baseline Huffman JPEG bytes → [H, W, 3] uint8 (see the module
    docstring)."""
    if data[:2] != JPEG_SIG:
        raise ValueError("not a JPEG file")
    qt: dict[int, np.ndarray] = {}
    dc_luts: dict[int, list[int]] = {}
    ac_luts: dict[int, list[int]] = {}
    frame = None
    coefs: dict[int, tuple[list, list]] = {}
    ri, pos = 0, 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG marker expected at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:  # EOI
            break
        if m == 0xD8 or 0xD0 <= m <= 0xD7:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        pos += length
        if m == 0xDB:  # DQT
            j = 0
            while j < len(seg):
                pq, tq = seg[j] >> 4, seg[j] & 15
                if pq:
                    raise ValueError("JPEG with 16-bit quantization tables is not supported "
                                     "(baseline JPEG only)")
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = np.frombuffer(seg, np.uint8, 64, j + 1)
                qt[tq] = q
                j += 65
        elif m == 0xC4:  # DHT
            j = 0
            while j < len(seg):
                tc, th = seg[j] >> 4, seg[j] & 15
                counts = seg[j + 1:j + 17]
                n = sum(counts)
                (ac_luts if tc else dc_luts)[th] = _huff_lut(counts, seg[j + 17:j + 17 + n])
                j += 17 + n
        elif m == 0xC0:  # SOF0
            prec, hgt, wid, nf = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise ValueError(f"{prec}-bit JPEG is not supported (8-bit only)")
            if hgt == 0:
                raise ValueError("JPEG with a DNL-defined height is not supported")
            if nf not in (1, 3):
                raise ValueError(f"JPEG with {nf} components is not supported (grey or YCbCr)")
            comps = [(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15, seg[8 + 3 * k])
                     for k in range(nf)]
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            mcus = (-(-hgt // (8 * vmax)), -(-wid // (8 * hmax)))
            frame = {"h": hgt, "w": wid, "comps": comps, "hmax": hmax, "vmax": vmax,
                     "mcus": mcus}
            coefs = {c[0]: ([], []) for c in comps}
        elif m in _SOF_NAMES:
            raise ValueError(f"{_SOF_NAMES[m]} JPEG is not supported (baseline JPEG only)")
        elif m == 0xDD:  # DRI
            (ri,) = struct.unpack(">H", seg[:2])
        elif m == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = seg[0]
            if ns != len(frame["comps"]):
                raise ValueError("JPEG with one scan per component is not supported "
                                 "(one interleaved scan only)")
            sel = [(seg[1 + 2 * k], seg[2 + 2 * k] >> 4, seg[2 + 2 * k] & 15) for k in range(ns)]
            by_id = {c[0]: c for c in frame["comps"]}
            scan, nb_x = [], {}
            for cid, td, ta in sel:
                _, hs, vs, _ = by_id[cid]
                nb_x[cid] = frame["mcus"][1] * hs
                if ns == 1:  # grey: one block an MCU over the component's
                    # own (unpadded) block grid, whatever its sampling factors
                    mcus = (-(-frame["h"] * vs // (8 * frame["vmax"])),
                            -(-frame["w"] * hs // (8 * frame["hmax"])))
                    hs = vs = 1
                else:
                    mcus = frame["mcus"]
                scan.append((cid, hs, vs, dc_luts[td], ac_luts[ta]))
            intervals, pos = _scan_intervals(data, pos)
            _decode_scan(intervals, scan, mcus, ri, nb_x, coefs)
        # APPn, COM and the rest: skipped
    if frame is None:
        raise ValueError("JPEG without a frame header")
    planes = []
    for cid, hs, vs, tq in frame["comps"]:
        bh, bw = frame["mcus"][0] * vs, frame["mcus"][1] * hs
        flat = np.zeros(bh * bw * 64, np.int64)
        pos_l, val_l = coefs[cid]
        flat[np.array(pos_l, np.int64)] = np.array(val_l, np.int64)
        blocks = (flat.reshape(-1, 64) * qt[tq]).reshape(bh, bw, 8, 8)
        px = idct_islow(blocks).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        dh = -(-frame["h"] * vs // frame["vmax"])
        dw = -(-frame["w"] * hs // frame["hmax"])
        up = _upsample(px[:dh, :dw], frame["hmax"] // hs, frame["vmax"] // vs)
        planes.append(up[: frame["h"], : frame["w"]])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
    return ycc_to_rgb(*planes)


# the standard tables (ITU T.81 Annex K), quantization in natural order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)
_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a"
    "25262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778"
    "797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f1"
    "1718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a73747576"
    "7778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4"
    "c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
_STD_HUFF = {  # (class, id): (counts, symbols)
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), _AC_LUMA_VALS),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), _AC_CHROMA_VALS),
}
SUBSAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}  # luma (H, V)


def _huff_codes(counts: bytes, symbols: bytes) -> dict[int, tuple[int, int]]:
    """symbol → (code, length) of a canonical Huffman table."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _dct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


def encode_jpeg(img: np.ndarray, quality: int = 75, subsampling: str = "4:2:0") -> bytes:
    """[H, W, 3] uint8 → baseline JPEG bytes (JFIF, YCbCr, the standard
    Huffman tables, quantization tables scaled by ``quality`` as libjpeg's
    ``jpeg_quality_scaling``; a float DCT)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes [H, W, 3] uint8, got {img.dtype} {img.shape}")
    hs, vs = SUBSAMPLING[subsampling]
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    tables = [np.clip((t * scale + 50) // 100, 1, 255) for t in (_Q_LUMA, _Q_CHROMA)]
    h, w, _ = img.shape
    f = img.astype(np.float64)
    ycc = [0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2],
           -0.168735892 * f[..., 0] - 0.331264108 * f[..., 1] + 0.5 * f[..., 2] + 128,
           0.5 * f[..., 0] - 0.418687589 * f[..., 1] - 0.081312411 * f[..., 2] + 128]
    mh, mw = 8 * vs, 8 * hs
    H, W = -(-h // mh) * mh, -(-w // mw) * mw
    planes = []
    for k, p in enumerate(ycc):
        p = np.pad(p, ((0, H - h), (0, W - w)), mode="edge")
        if k:  # chroma: the mean of each hs x vs box
            p = p.reshape(H // vs, vs, W // hs, hs).mean(axis=(1, 3))
        planes.append(p)
    c = _dct_matrix()
    blocks = []  # per component [by, bx, 64] quantized, zigzag order
    for k, p in enumerate(planes):
        b = p.reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8).transpose(0, 2, 1, 3) - 128.0
        coef = c @ b @ c.T
        qt = tables[0 if k == 0 else 1].reshape(8, 8)
        q = np.round(coef / qt).astype(np.int64)
        blocks.append(q.reshape(*coef.shape[:2], 64)[..., ZIGZAG])
    codes = {key: _huff_codes(*v) for key, v in _STD_HUFF.items()}
    out = bytearray()
    acc = nb = 0

    def put(code: int, length: int) -> None:
        nonlocal acc, nb
        acc = (acc << length) | code
        nb += length
        while nb >= 8:
            nb -= 8
            byte = (acc >> nb) & 255
            out.append(byte)
            if byte == 255:
                out.append(0)
        acc &= (1 << nb) - 1

    def put_value(v: int, table) -> None:
        s = abs(v).bit_length()
        put(*table[s])
        if s:
            put(v if v >= 0 else v + (1 << s) - 1, s)

    pred = [0, 0, 0]
    by, bx = H // (8 * vs), W // (8 * hs)
    for my in range(by):
        for mx in range(bx):
            for k in range(3):
                n_v, n_h = (vs, hs) if k == 0 else (1, 1)
                dc, ac = codes[(0, min(k, 1))], codes[(1, min(k, 1))]
                for oy in range(n_v):
                    for ox in range(n_h):
                        blk = blocks[k][my * n_v + oy, mx * n_h + ox].tolist()
                        put_value(blk[0] - pred[k], dc)
                        pred[k] = blk[0]
                        run = 0
                        for v in blk[1:]:
                            if v == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac[0xF0])
                                run -= 16
                            s = abs(v).bit_length()
                            put(*ac[(run << 4) | s])
                            put(v if v >= 0 else v + (1 << s) - 1, s)
                            run = 0
                        if run:
                            put(*ac[0x00])
    if nb:
        put((1 << (8 - nb)) - 1, 8 - nb)

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    head = b"\xff\xd8" + seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    for k, t in enumerate(tables):
        head += seg(0xDB, bytes([k]) + bytes(t[ZIGZAG].astype(np.uint8).tolist()))
    head += seg(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                + bytes([1, (hs << 4) | vs, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for (cls, tid), (counts, syms) in _STD_HUFF.items():
        head += seg(0xC4, bytes([(cls << 4) | tid]) + counts + syms)
    head += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return head + bytes(out) + b"\xff\xd9"


# ---------------------------------------------------------------------------
# Pillow's bicubic resize
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic kernel (a = -0.5), its operations in its order."""
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((((x - 5.0) * x + 8.0) * x - 4.0) * -0.5)
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _resample_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``:
    (first input index [out], fixed-point weights [out, ksize], ksize)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    j = np.arange(ksize)[None, :]
    w = _bicubic(((xmin[:, None] + j).astype(np.float64) - center[:, None] + 0.5) * ss)
    w = np.where(j < xmax[:, None], w, 0.0)
    ww = np.cumsum(w, axis=1)[:, -1:]  # summed in order, as the C loop does
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = w * (1 << _PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + fixed), np.trunc(0.5 + fixed)).astype(np.int64)
    return xmin, kk, ksize


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis`` (0 rows, 1 columns)."""
    in_size = img.shape[axis]
    xmin, kk, ksize = _resample_coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    extra = (None,) * (src.ndim - 1)
    for j in range(ksize):
        idx = np.minimum(xmin + j, in_size - 1)  # a zero weight past the edge
        acc += src[idx] * kk[(slice(None), j) + extra]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """[H, W, C] uint8 → [size[1], size[0], C] uint8, as Pillow's
    ``Image.resize(size)`` (``size`` is (width, height), as Pillow's)."""
    out_w, out_h = size
    img = np.asarray(img, np.uint8)
    if img.shape[1] != out_w:
        img = _resample_axis(img, out_w, 1)
    if img.shape[0] != out_h:
        img = _resample_axis(img, out_h, 0)
    return img
