"""Host-side serving ladders (pure Python, as in the JAX package).

  * `PrefillLadder` — the prompt-length buckets admission rounds up to
    (powers-of-two multiples of the 8-token block capped at max_seq, or an
    explicit list; a prompt that fits no bucket raises).
  * `DecodeLadder` — the paged engine's context-length buckets: each
    decode step attends a `bucket // 8`-entry slice of the block table
    covering the deepest live slot's flushed watermark, so the plain scan's
    work tracks occupied context; the slice is exact on outputs.
"""
from __future__ import annotations

from dataclasses import dataclass

BLOCK = 8


def auto_buckets(max_seq: int) -> tuple[int, ...]:
    """Powers-of-two multiples of BLOCK capped at max_seq, max_seq included.

    max_seq=48 -> (8, 16, 32, 48); max_seq=64 -> (8, 16, 32, 64).
    """
    assert max_seq % BLOCK == 0 and max_seq >= BLOCK, max_seq
    out = []
    b = BLOCK
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(out)


@dataclass(frozen=True)
class PrefillLadder:
    """The fixed prompt-length buckets admission rounds up to."""

    buckets: tuple[int, ...]

    @classmethod
    def build(cls, max_seq: int, buckets=None) -> "PrefillLadder":
        if buckets is None:
            return cls(auto_buckets(max_seq))
        buckets = tuple(sorted(int(b) for b in buckets))
        if not buckets:
            raise ValueError("empty prefill ladder")
        for b in buckets:
            if b % BLOCK or b < BLOCK:
                raise ValueError(f"ladder bucket {b} is not a multiple of {BLOCK}")
        if buckets[-1] > max_seq:
            raise ValueError(
                f"ladder bucket {buckets[-1]} exceeds max_seq={max_seq}")
        return cls(buckets)

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest bucket covering `prompt_len`; raises off-ladder."""
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt of {prompt_len} tokens fits no prefill bucket "
            f"{self.buckets} (widen prefill_buckets or raise max_seq)")


@dataclass(frozen=True)
class DecodeLadder:
    """Context-length buckets of the paged decode step; always ends at
    max_seq, so every legal flushed watermark has a covering bucket."""

    buckets: tuple[int, ...]

    @classmethod
    def build(cls, max_seq: int, buckets=None) -> "DecodeLadder":
        if buckets is None:
            return cls(auto_buckets(max_seq))
        if buckets is False or buckets == "off":
            return cls((max_seq,))  # single full-capacity bucket
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets:
            raise ValueError("empty decode ladder")
        for b in buckets:
            if b % BLOCK or b < BLOCK:
                raise ValueError(f"decode bucket {b} is not a multiple of {BLOCK}")
        if buckets[-1] > max_seq:
            raise ValueError(
                f"decode bucket {buckets[-1]} exceeds max_seq={max_seq}")
        if buckets[-1] < max_seq:
            buckets = buckets + (max_seq,)
        return cls(buckets)

    def bucket_for(self, context_tokens: int) -> int:
        """Smallest bucket covering `context_tokens` of flushed context."""
        for b in self.buckets:
            if context_tokens <= b:
                return b
        raise ValueError(
            f"flushed context of {context_tokens} tokens exceeds the decode "
            f"ladder {self.buckets}")
