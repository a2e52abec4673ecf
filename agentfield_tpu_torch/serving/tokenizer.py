"""Tokenizers for the port's model node.

``ByteTokenizer`` is the port's copy of ``agentfield_tpu/serving/
model_node.py``'s byte-level tokenizer (same ids). The HF tokenizer adapter
is not ported yet: the card's machine has no ``transformers``.
"""

from __future__ import annotations


class ByteTokenizer:
    """Trivial byte-level tokenizer for random-weight models.

    decode(encode(x)) is lossy for ids >= 256, so TEXT-level multi-turn
    prompts won't prefix-match the session KV cache through this tokenizer —
    pass `tokens` for session reuse."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.eos_token_id = 0  # NUL: never legal inside generated text

    def encode(self, text: str) -> list[int]:
        return [b % self.vocab_size for b in text.encode("utf-8")]

    def decode(self, tokens: list[int]) -> str:
        return bytes(t % 256 for t in tokens).decode("utf-8", errors="replace")

    def token_bytes(self, vocab_size: int) -> list[bytes]:
        """Per-id byte strings for grammar compilation (serving/grammar.py).
        Ids >= 256 alias low bytes through decode(), but for constrained
        decoding they are redundant: they map to NUL, so the grammar only
        ever selects the canonical single-byte ids."""
        out = [bytes([i]) for i in range(min(256, vocab_size))]
        out += [b"\x00"] * (vocab_size - len(out))
        return out
