"""Chained prefix block hashing — the port's copy of
``agentfield_tpu/prefix_hash.py`` (``chain_hash``, ``page_chain_hashes``,
``sketch_digest``).

The shared-prefix page pool content-addresses KV pages by chained
blake2b-128 block hashes, and a node's heartbeat sketch publishes them
truncated to ``SKETCH_DIGEST_BYTES``. The bytes hashed must be exactly the
JAX package's, or a mixed fleet's prefix-affinity scores silently read zero
and its nodes fetch no page from each other; the parity tests hold the two
byte for byte.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np

DIGEST_BYTES = 16
SKETCH_DIGEST_BYTES = 8  # a sketch digest: routing only, verified again at lookup


def chain_hash(prev: bytes, tokens: Sequence[int]) -> bytes:
    """Chained block hash over one full page of token ids: a page's identity
    is (everything before it, its own tokens), so two requests share a page
    iff their prompts agree on the ENTIRE prefix through that page."""
    h = hashlib.blake2b(prev, digest_size=DIGEST_BYTES)
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.digest()


def page_chain_hashes(tokens: Sequence[int], page_size: int) -> list[bytes]:
    """Chained hash per full page of `tokens` (computed once per request and
    passed to the pool's peek()/lookup() instead of re-hashing each tick)."""
    out: list[bytes] = []
    h = b""
    for off in range(0, (len(tokens) // page_size) * page_size, page_size):
        h = chain_hash(h, tokens[off : off + page_size])
        out.append(h)
    return out


def sketch_digest(chain: bytes) -> str:
    """A chain hash as a node's heartbeat prefix sketch carries it: its
    first ``SKETCH_DIGEST_BYTES`` in hex (a false positive only costs a
    mis-routed request one ordinary prefill)."""
    return chain[:SKETCH_DIGEST_BYTES].hex()
