"""HPACK (RFC 7541), the header compression of HTTP/2, on the standard
library: the header half of the port's gRPC transport (``grpc_h2.py``).

The decoder is complete: the static table (Appendix A), a dynamic table
with eviction and size updates (section 4), the integer and string codings
(5.1, 5.2) and the Huffman code (Appendix B), and every field
representation (6.1-6.3): indexed, literal with incremental indexing
(grpcio's client sends every header so, so a channel's second call refers
to the dynamic table), without indexing, never indexed. A Huffman string
whose padding is longer than 7 bits, is not all ones, or holds EOS is a
``HPACKError``.

The encoder keeps no dynamic table: a header that is in the static table
whole goes as its index, any other as a literal without indexing (the
static table's name index where it has the name), with plain strings.
That is a valid HPACK encoder whatever table size the peer allows.
"""

from __future__ import annotations

from collections import deque


class HPACKError(ValueError):
    """A header block that cannot be decoded (COMPRESSION_ERROR)."""


STATIC_TABLE: tuple[tuple[str, str], ...] = (
    (":authority", ""), (":method", "GET"), (":method", "POST"), (":path", "/"),
    (":path", "/index.html"), (":scheme", "http"), (":scheme", "https"),
    (":status", "200"), (":status", "204"), (":status", "206"), (":status", "304"),
    (":status", "400"), (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""), ("accept-ranges", ""),
    ("accept", ""), ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""), ("content-disposition", ""),
    ("content-encoding", ""), ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""), ("cookie", ""),
    ("date", ""), ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""), ("location", ""),
    ("max-forwards", ""), ("proxy-authenticate", ""), ("proxy-authorization", ""),
    ("range", ""), ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""), ("transfer-encoding", ""),
    ("user-agent", ""), ("vary", ""), ("via", ""), ("www-authenticate", ""),
)
assert len(STATIC_TABLE) == 61

# Appendix B: (code, bit length) of each symbol 0..255, then EOS (256).
HUFFMAN_CODES: tuple[tuple[int, int], ...] = (
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28), (0xfffffe4, 28),
    (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28), (0xfffffe8, 28), (0xffffea, 24),
    (0x3ffffffc, 30), (0xfffffe9, 28), (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28),
    (0xfffffec, 28), (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28), (0xffffff4, 28),
    (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28), (0xffffff8, 28), (0xffffff9, 28),
    (0xffffffa, 28), (0xffffffb, 28),
    # 32 ' ' .. 47 '/'
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12), (0x1ff9, 13), (0x15, 6), (0xf8, 8),
    (0x7fa, 11), (0x3fa, 10), (0x3fb, 10), (0xf9, 8), (0x7fb, 11), (0xfa, 8), (0x16, 6),
    (0x17, 6), (0x18, 6),
    # 48 '0' .. 63 '?'
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6), (0x1a, 6), (0x1b, 6), (0x1c, 6), (0x1d, 6),
    (0x1e, 6), (0x1f, 6), (0x5c, 7), (0xfb, 8), (0x7ffc, 15), (0x20, 6), (0xffb, 12),
    (0x3fc, 10),
    # 64 '@' .. 95 '_'
    (0x1ffa, 13), (0x21, 6), (0x5d, 7), (0x5e, 7), (0x5f, 7), (0x60, 7), (0x61, 7),
    (0x62, 7), (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7), (0x67, 7), (0x68, 7), (0x69, 7),
    (0x6a, 7), (0x6b, 7), (0x6c, 7), (0x6d, 7), (0x6e, 7), (0x6f, 7), (0x70, 7), (0x71, 7),
    (0x72, 7), (0xfc, 8), (0x73, 7), (0xfd, 8), (0x1ffb, 13), (0x7fff0, 19), (0x1ffc, 13),
    (0x3ffc, 14), (0x22, 6),
    # 96 '`' .. 127
    (0x7ffd, 15), (0x3, 5), (0x23, 6), (0x4, 5), (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6),
    (0x27, 6), (0x6, 5), (0x74, 7), (0x75, 7), (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5),
    (0x2b, 6), (0x76, 7), (0x2c, 6), (0x8, 5), (0x9, 5), (0x2d, 6), (0x77, 7), (0x78, 7),
    (0x79, 7), (0x7a, 7), (0x7b, 7), (0x7ffe, 15), (0x7fc, 11), (0x3ffd, 14), (0x1ffd, 13),
    (0xffffffc, 28),
    # 128 .. 255
    (0xfffe6, 20), (0x3fffd2, 22), (0xfffe7, 20), (0xfffe8, 20), (0x3fffd3, 22),
    (0x3fffd4, 22), (0x3fffd5, 22), (0x7fffd9, 23), (0x3fffd6, 22), (0x7fffda, 23),
    (0x7fffdb, 23), (0x7fffdc, 23), (0x7fffdd, 23), (0x7fffde, 23), (0xffffeb, 24),
    (0x7fffdf, 23), (0xffffec, 24), (0xffffed, 24), (0x3fffd7, 22), (0x7fffe0, 23),
    (0xffffee, 24), (0x7fffe1, 23), (0x7fffe2, 23), (0x7fffe3, 23), (0x7fffe4, 23),
    (0x1fffdc, 21), (0x3fffd8, 22), (0x7fffe5, 23), (0x3fffd9, 22), (0x7fffe6, 23),
    (0x7fffe7, 23), (0xffffef, 24), (0x3fffda, 22), (0x1fffdd, 21), (0xfffe9, 20),
    (0x3fffdb, 22), (0x3fffdc, 22), (0x7fffe8, 23), (0x7fffe9, 23), (0x1fffde, 21),
    (0x7fffea, 23), (0x3fffdd, 22), (0x3fffde, 22), (0xfffff0, 24), (0x1fffdf, 21),
    (0x3fffdf, 22), (0x7fffeb, 23), (0x7fffec, 23), (0x1fffe0, 21), (0x1fffe1, 21),
    (0x3fffe0, 22), (0x1fffe2, 21), (0x7fffed, 23), (0x3fffe1, 22), (0x7fffee, 23),
    (0x7fffef, 23), (0xfffea, 20), (0x3fffe2, 22), (0x3fffe3, 22), (0x3fffe4, 22),
    (0x7ffff0, 23), (0x3fffe5, 22), (0x3fffe6, 22), (0x7ffff1, 23), (0x3ffffe0, 26),
    (0x3ffffe1, 26), (0xfffeb, 20), (0x7fff1, 19), (0x3fffe7, 22), (0x7ffff2, 23),
    (0x3fffe8, 22), (0x1ffffec, 25), (0x3ffffe2, 26), (0x3ffffe3, 26), (0x3ffffe4, 26),
    (0x7ffffde, 27), (0x7ffffdf, 27), (0x3ffffe5, 26), (0xfffff1, 24), (0x1ffffed, 25),
    (0x7fff2, 19), (0x1fffe3, 21), (0x3ffffe6, 26), (0x7ffffe0, 27), (0x7ffffe1, 27),
    (0x3ffffe7, 26), (0x7ffffe2, 27), (0xfffff2, 24), (0x1fffe4, 21), (0x1fffe5, 21),
    (0x3ffffe8, 26), (0x3ffffe9, 26), (0xffffffd, 28), (0x7ffffe3, 27), (0x7ffffe4, 27),
    (0x7ffffe5, 27), (0xfffec, 20), (0xfffff3, 24), (0xfffed, 20), (0x1fffe6, 21),
    (0x3fffe9, 22), (0x1fffe7, 21), (0x1fffe8, 21), (0x7ffff3, 23), (0x3fffea, 22),
    (0x3fffeb, 22), (0x1ffffee, 25), (0x1ffffef, 25), (0xfffff4, 24), (0xfffff5, 24),
    (0x3ffffea, 26), (0x7ffff4, 23), (0x3ffffeb, 26), (0x7ffffe6, 27), (0x3ffffec, 26),
    (0x3ffffed, 26), (0x7ffffe7, 27), (0x7ffffe8, 27), (0x7ffffe9, 27), (0x7ffffea, 27),
    (0x7ffffeb, 27), (0xffffffe, 28), (0x7ffffec, 27), (0x7ffffed, 27), (0x7ffffee, 27),
    (0x7ffffef, 27), (0x7fffff0, 27), (0x3ffffee, 26),
    # 256 EOS
    (0x3fffffff, 30),
)
EOS = 256
assert len(HUFFMAN_CODES) == 257

# decoding: (bit length, code) → symbol
_HUFF_DECODE = {(n, c): sym for sym, (c, n) in enumerate(HUFFMAN_CODES)}
_HUFF_MIN = min(n for _, n in HUFFMAN_CODES)


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    code = n = 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = code << 1 | (byte >> shift & 1)
            n += 1
            if n < _HUFF_MIN:
                continue
            sym = _HUFF_DECODE.get((n, code))
            if sym is None:
                if n >= 30:
                    raise HPACKError("invalid Huffman code")
                continue
            if sym == EOS:
                raise HPACKError("EOS in a Huffman-coded string")
            out.append(sym)
            code = n = 0
    if n > 7:
        raise HPACKError("Huffman padding longer than 7 bits")
    if code != (1 << n) - 1:
        raise HPACKError("Huffman padding is not the most significant bits of EOS")
    return bytes(out)


def encode_integer(value: int, prefix_bits: int, first: int = 0) -> bytes:
    """RFC 7541 5.1: ``value`` with an N-bit prefix; ``first`` holds the
    representation's flag bits above the prefix."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([first | value])
    out = bytearray([first | limit])
    value -= limit
    while value >= 128:
        out.append(value & 0x7F | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_integer(buf: bytes, pos: int, prefix_bits: int) -> tuple[int, int]:
    if pos >= len(buf):
        raise HPACKError("truncated integer")
    limit = (1 << prefix_bits) - 1
    value = buf[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(buf):
            raise HPACKError("truncated integer")
        b = buf[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 28:
            raise HPACKError("integer overflow")


def encode_string(raw: bytes) -> bytes:
    """A plain (not Huffman-coded) string literal."""
    return encode_integer(len(raw), 7) + raw


def decode_string(buf: bytes, pos: int) -> tuple[bytes, int]:
    if pos >= len(buf):
        raise HPACKError("truncated string")
    huff = buf[pos] & 0x80
    n, pos = decode_integer(buf, pos, 7)
    if pos + n > len(buf):
        raise HPACKError("string longer than its header block")
    raw = bytes(buf[pos:pos + n])
    return (huffman_decode(raw) if huff else raw), pos + n


def entry_size(name: bytes, value: bytes) -> int:
    return len(name) + len(value) + 32  # RFC 7541 4.1


class Decoder:
    """One connection's header-block decoder (its dynamic table lives as
    long as the connection). ``max_allowed`` is our SETTINGS_HEADER_TABLE_SIZE:
    the most a size update may ask for."""

    def __init__(self, max_allowed: int = 4096):
        self.max_allowed = max_allowed
        self.max_size = max_allowed
        self.size = 0
        self.table: deque[tuple[bytes, bytes]] = deque()  # newest first

    def _evict(self) -> None:
        while self.size > self.max_size:
            name, value = self.table.pop()
            self.size -= entry_size(name, value)

    def _add(self, name: bytes, value: bytes) -> None:
        size = entry_size(name, value)
        if size > self.max_size:  # 4.4: an entry larger than the table empties it
            self.table.clear()
            self.size = 0
            return
        self.table.appendleft((name, value))
        self.size += size
        self._evict()

    def _get(self, index: int) -> tuple[bytes, bytes]:
        if index == 0:
            raise HPACKError("index 0")
        if index <= len(STATIC_TABLE):
            name, value = STATIC_TABLE[index - 1]
            return name.encode(), value.encode()
        i = index - len(STATIC_TABLE) - 1
        if i >= len(self.table):
            raise HPACKError(f"index {index} beyond the dynamic table")
        return self.table[i]

    def decode(self, block: bytes) -> list[tuple[str, str]]:
        """A whole header block (HEADERS + CONTINUATION payloads) → its
        header list, names and values as latin-1 strings."""
        out: list[tuple[str, str]] = []
        pos, seen_field = 0, False
        while pos < len(block):
            b = block[pos]
            if b & 0x80:  # 6.1 indexed
                index, pos = decode_integer(block, pos, 7)
                name, value = self._get(index)
            elif b & 0xE0 == 0x20:  # 6.3 dynamic table size update
                if seen_field:
                    raise HPACKError("table size update after a header field")
                size, pos = decode_integer(block, pos, 5)
                if size > self.max_allowed:
                    raise HPACKError(f"table size {size} over the allowed {self.max_allowed}")
                self.max_size = size
                self._evict()
                continue
            else:
                if b & 0xC0 == 0x40:  # 6.2.1 incremental indexing
                    index, pos = decode_integer(block, pos, 6)
                    add = True
                else:  # 6.2.2 without indexing (0000), 6.2.3 never indexed (0001)
                    index, pos = decode_integer(block, pos, 4)
                    add = False
                if index:
                    name = self._get(index)[0]
                else:
                    name, pos = decode_string(block, pos)
                value, pos = decode_string(block, pos)
                if add:
                    self._add(name, value)
            seen_field = True
            out.append((name.decode("latin-1"), value.decode("latin-1")))
        return out


_STATIC_FULL = {}
_STATIC_NAME = {}
for _i, (_n, _v) in enumerate(STATIC_TABLE, 1):
    _STATIC_FULL.setdefault((_n, _v), _i)
    _STATIC_NAME.setdefault(_n, _i)


def encode_headers(headers: list[tuple[str, str]]) -> bytes:
    """A header list → one header block, with no dynamic table state."""
    out = bytearray()
    for name, value in headers:
        i = _STATIC_FULL.get((name, value))
        if i is not None:
            out += encode_integer(i, 7, 0x80)
            continue
        i = _STATIC_NAME.get(name, 0)
        out += encode_integer(i, 4)  # literal without indexing
        if not i:
            out += encode_string(name.encode("latin-1"))
        out += encode_string(value.encode("latin-1"))
    return bytes(out)
