"""The port's image codecs (``agentfield_tpu_torch.models.media_codec``)
against Pillow, which the JAX node decodes, encodes and resizes with, on
files written in the test:

- PNG that Pillow writes in every colour type it writes (RGB, RGBA, L, LA,
  P, 1-bit) and PNG that the test's own writer makes (``_png``: every colour
  type at bit depth 8, grey and palette at 1, 2 and 4 bits, every row filter
  in turn or None/Sub/Up only, plain and Adam7-interlaced), decoded by
  both: pixels bit-equal, as ``Image.open(...).convert("RGB")`` gives them;
- baseline JPEG that Pillow writes at quality 75 and 95, with 4:4:4, 4:2:2
  and 4:2:0 sampling, odd and even sizes, grey, and with restart markers:
  pixels bit-equal to Pillow's decode (libjpeg-turbo's islow IDCT, fancy
  upsampling and YCbCr tables);
- the resize, up and down, non-square and one side only: bit-equal to
  ``Image.resize``'s default (bicubic);
- the port's encoders: its PNG decodes in Pillow to the same pixels, its
  JPEG decodes in Pillow and in the port to the same pixels;
- the port's PNG encoder picks each row's filter by libpng's least-sum rule;
- what the codec refuses: progressive and extended sequential JPEG, colour
  JPEG in one scan per component, 16-bit quantization tables and 16-bit
  PNG raise ValueError naming the format; bytes that are neither raise
  ValueError.

Tolerance: none — a difference of one level is a fault.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from agentfield_tpu_torch.models import media_codec as mc


def _picture(seed: int, h: int, w: int) -> np.ndarray:
    """Smooth colour fields plus noise, so JPEG blocks hold both."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (max(2, h // 8), max(2, w // 8), 3), dtype=np.uint8)
    base = np.asarray(Image.fromarray(coarse).resize((w, h)), np.int16)
    return np.clip(base + rng.integers(-25, 26, (h, w, 3)), 0, 255).astype(np.uint8)


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _save(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


SIZES = [(1, 1), (3, 5), (17, 9), (37, 53), (64, 64), (120, 97)]


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1"])
@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_png_from_pillow(mode, hw):
    img = Image.fromarray(_picture(1, *hw))
    img = img.quantize(200) if mode == "P" else img.convert(mode)
    data = _save(img, "PNG")
    np.testing.assert_array_equal(mc.decode_png(data), _pil_rgb(data))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, n] samples of ``depth`` bits → [h, bytes] rows, MSB first."""
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    h, n = samples.shape
    pad = np.zeros((h, -n % per), samples.dtype)
    s = np.concatenate([samples, pad], axis=1).reshape(h, -1, per).astype(np.uint16)
    shifts = np.arange(per - 1, -1, -1) * depth
    return (s << shifts).sum(axis=2).astype(np.uint8)


def _filter_rows(rows: np.ndarray, bpp: int, first: int, kinds: int = 5) -> bytes:
    """Filter each row with type (first + row) % kinds (the PNG spec's
    filters; kinds 3 takes None, Sub and Up only)."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        ft = (first + y) % kinds
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = b
        elif ft == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(bytes([ft]) + ((row - pred) & 255).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png(samples: np.ndarray, ctype: int, depth: int, interlace: bool, palette=None,
         kinds: int = 5) -> bytes:
    """The test's own PNG writer: samples [h, w, c], the first ``kinds``
    filters in turn."""
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)

    def image(px, first):
        rows = _pack(px.reshape(px.shape[0], -1), depth)
        return _filter_rows(rows, bpp, first, kinds)

    if interlace:
        raw = b"".join(image(samples[y0::dy, x0::dx], k) for k, (x0, y0, dx, dy) in
                       enumerate(ADAM7) if samples[y0::dy, x0::dx].size)
    else:
        raw = image(samples, 0)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                                            0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


PNG_KINDS = [(0, 8), (2, 8), (3, 8), (4, 8), (6, 8), (0, 1), (0, 2), (0, 4), (3, 1), (3, 2),
             (3, 4)]


@pytest.mark.parametrize("kinds", [5, 3], ids=["all_filters", "none_sub_up"])
@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", PNG_KINDS, ids=lambda v: str(v))
@pytest.mark.parametrize("hw", [(1, 1), (7, 5), (19, 33)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_png_every_type_filter_and_interlace(ctype, depth, interlace, hw, kinds):
    rng = np.random.default_rng(ctype * 100 + depth)
    c = CHANNELS[ctype]
    samples = rng.integers(0, 1 << depth, (*hw, c)).astype(np.uint8)
    palette = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
    data = _png(samples, ctype, depth, interlace, palette, kinds)
    np.testing.assert_array_equal(mc.decode_png(data), _pil_rgb(data))


@pytest.mark.parametrize("band_bytes", [1 << 10, 6 * 1024], ids=["rows_of_3", "rows_of_16"])
@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
def test_png_unfilters_a_band_of_rows_at_a_time(band_bytes, interlace, monkeypatch):
    """A tall image is undone in bands of rows (``UNFILTER_BAND_BYTES``
    set small here), each band's first row reading the last of the band
    before: every filter, pixels equal to Pillow's."""
    monkeypatch.setattr(mc, "UNFILTER_BAND_BYTES", band_bytes)
    samples = np.random.default_rng(10).integers(0, 256, (67, 45, 3)).astype(np.uint8)
    data = _png(samples, 2, 8, interlace)
    np.testing.assert_array_equal(mc.decode_png(data), _pil_rgb(data))


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("hw", SIZES + [(480, 640)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_from_pillow(quality, subsampling, hw):
    data = _save(Image.fromarray(_picture(2, *hw)), "JPEG", quality=quality,
                 subsampling=subsampling)
    np.testing.assert_array_equal(mc.decode_jpeg(data), _pil_rgb(data))


@pytest.mark.parametrize("kind", ["grey", "restarts", "restarts_420"])
def test_jpeg_grey_and_restart_markers(kind):
    img = Image.fromarray(_picture(3, 45, 61))
    if kind == "grey":
        data = _save(img.convert("L"), "JPEG", quality=85)
    else:
        data = _save(img, "JPEG", quality=85, restart_marker_blocks=3,
                     subsampling=2 if kind == "restarts_420" else 0)
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    np.testing.assert_array_equal(mc.decode_jpeg(data), _pil_rgb(data))


RESIZES = [((8, 8), (32, 32)), ((480, 640), (336, 336)), ((37, 53), (20, 30)),
           ((37, 53), (37, 91)), ((37, 53), (12, 53)), ((1, 1), (5, 3)), ((5, 7), (5, 7)),
           ((1080, 1920), (224, 224))]


@pytest.mark.parametrize("src,dst", RESIZES, ids=lambda v: f"{v[0]}x{v[1]}")
def test_resize_matches_pillow(src, dst):
    img = _picture(4, *src)
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0])))
    np.testing.assert_array_equal(mc.resize_bicubic(img, (dst[1], dst[0])), want)


@pytest.mark.parametrize("hw", [(1, 1), (37, 53), (480, 640)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_port_png_encoder(hw):
    img = _picture(5, *hw)
    data = mc.encode_png(img)
    np.testing.assert_array_equal(_pil_rgb(data), img)
    np.testing.assert_array_equal(mc.decode_png(data), img)


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("hw", [(8, 8), (37, 53), (480, 640)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_port_jpeg_encoder(subsampling, hw):
    img = _picture(6, *hw)
    data = mc.encode_jpeg(img, quality=90, subsampling=subsampling)
    got = mc.decode_jpeg(data)
    np.testing.assert_array_equal(got, _pil_rgb(data))
    # a faithful picture: the mean level error of a quality-90 JPEG of noise
    assert np.abs(got.astype(np.int64) - img).mean() < 12.0


def _png_rows(data: bytes) -> np.ndarray:
    """The inflated IDAT of a PNG: [h, 1 + row bytes], filter type first."""
    pos, idat = 8, []
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    h = struct.unpack(">I", data[20:24])[0]
    return np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, -1)


@pytest.mark.parametrize("hw", [(37, 53), (120, 97)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_port_png_encoder_picks_filters_as_libpng(hw):
    """Each row's filter is the least sum of its filtered bytes read as
    signed, the first on a tie (libpng's ``png_write_find_filter``), each
    row computed on its own by the test's ``_filter_rows``."""
    img = _picture(9, *hw)
    rows = _png_rows(mc.encode_png(img))
    flat = img.reshape(hw[0], -1)
    for y in range(hw[0]):
        pair, want = flat[max(0, y - 1):y + 1], []
        for ft in range(5):  # row y filtered with ft (the row above with ft - 1)
            body = np.frombuffer(_filter_rows(pair, 3, (ft + 1 - len(pair)) % 5)[
                -flat.shape[1]:], np.uint8).astype(np.int32)
            want.append(int(np.minimum(body, 256 - body).sum()))
        assert rows[y, 0] == int(np.argmin(want)), (y, want)
    assert set(rows[:, 0].tolist()) & {3, 4}, "no Average or Paeth row"


def test_refusals_name_the_format():
    img = Image.fromarray(_picture(7, 16, 16))
    with pytest.raises(ValueError, match="progressive JPEG"):
        mc.decode_jpeg(_save(img, "JPEG", progressive=True))
    base = _save(img, "JPEG")
    with pytest.raises(ValueError, match="extended sequential JPEG"):
        mc.decode_jpeg(base.replace(b"\xff\xc0", b"\xff\xc1", 1))
    sos = base.index(b"\xff\xda")
    one_comp = b"\xff\xda\x00\x08\x01\x01\x00\x00\x3f\x00"
    with pytest.raises(ValueError, match="one scan per component"):
        mc.decode_jpeg(base[:sos] + one_comp + base[sos + 2 + 12:])
    dqt = base.index(b"\xff\xdb")
    with pytest.raises(ValueError, match="16-bit quantization"):
        mc.decode_jpeg(base[:dqt + 4] + bytes([base[dqt + 4] | 0x10]) + base[dqt + 5:])
    grey16 = Image.fromarray((_picture(7, 16, 16)[..., 0].astype(np.uint16) * 257))
    with pytest.raises(ValueError, match="16-bit PNG"):
        mc.decode_png(_save(grey16, "PNG"))
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        mc.decode_image(b"GIF89a....")
    with pytest.raises(ValueError):
        mc.decode_png(mc.encode_png(_picture(7, 4, 4))[:40])


def test_decode_image_dispatches():
    img = _picture(8, 9, 11)
    np.testing.assert_array_equal(mc.decode_image(mc.encode_png(img)), img)
    jpeg = _save(Image.fromarray(img), "JPEG")
    np.testing.assert_array_equal(mc.decode_image(jpeg), _pil_rgb(jpeg))
