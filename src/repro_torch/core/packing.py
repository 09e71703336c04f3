"""Bit-packing of codes into 32-bit words (plain PyTorch layer).

Counterpart of ``repro/core/packing.py``: 32/b codes per word along the
last axis, LSB first, zero padding. Packed words are held as
``torch.int32`` bit-views of the uint32 words (PyTorch has no shifts or
adds for ``torch.uint32`` on the CPU); numpy callers convert with
``.view(np.uint32)`` / ``.view(np.int32)``. Shifts and popcounts run in
int64 masked to 32 bits, because int32 ``>>`` is arithmetic.
"""
from __future__ import annotations

import torch

__all__ = ["MASK32", "as_u32", "as_i32", "codes_per_word", "packed_width",
           "pack_codes", "unpack_codes", "hamming_packed",
           "match_count_packed_1bit", "field_lsb_mask",
           "fold_nonzero_fields", "mismatch_count_words",
           "match_count_packed", "bitmask_width", "pack_bitmask",
           "unpack_bitmask"]

MASK32 = 0xFFFFFFFF


def as_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit-view -> int64 holding the uint32 value in [0, 2^32)."""
    return words.to(torch.int64) & MASK32


def as_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 bit-view of its low 32 bits (two's complement)."""
    v = v & MASK32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def codes_per_word(bits: int) -> int:
    """32 // bits; bits must be one of 1, 2, 4, 8, 16."""
    if bits not in (1, 2, 4, 8, 16):
        raise ValueError(f"bits must divide 32 and be <=16, got {bits}")
    return 32 // bits


def packed_width(k: int, bits: int) -> int:
    """Words per row: ceil(k / (32/bits))."""
    cpw = codes_per_word(bits)
    return (k + cpw - 1) // cpw


def _shifts(bits: int, device) -> torch.Tensor:
    return torch.arange(codes_per_word(bits), dtype=torch.int64,
                        device=device) * bits


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer codes [..., k] -> int32 words [..., ceil(k/(32/bits))].

    Each word is the uint32 sum of ``code << (i*bits)`` (a bitwise or
    for codes in [0, 2^bits)); k is zero-padded to a multiple of 32/bits.
    """
    cpw = codes_per_word(bits)
    k = codes.shape[-1]
    c = codes.to(torch.int64) & MASK32
    pad = (-k) % cpw
    if pad:
        c = torch.nn.functional.pad(c, (0, pad))
    c = c.reshape(c.shape[:-1] + (c.shape[-1] // cpw, cpw))
    return as_i32(torch.sum((c << _shifts(bits, c.device)) & MASK32, dim=-1))


def unpack_codes(words: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Inverse of ``pack_codes``: int32 words [..., W] -> int32 [..., k]."""
    c = (as_u32(words)[..., None] >> _shifts(bits, words.device)) \
        & ((1 << bits) - 1)
    return c.reshape(words.shape[:-1] + (words.shape[-1] * c.shape[-1],))[
        ..., :k].to(torch.int32)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between int32 word rows of 1-bit codes [..., W]
    -> int32 [...]: the summed popcount of a ^ b."""
    return _popcount32(as_u32(a) ^ as_u32(b)).sum(dim=-1).to(torch.int32)


def match_count_packed_1bit(a: torch.Tensor, b: torch.Tensor,
                            k: int) -> torch.Tensor:
    """Colliding 1-bit codes: k - hamming (zero padding cancels in the
    xor)."""
    return k - hamming_packed(a, b)


def field_lsb_mask(bits: int) -> int:
    """A 1 at the least-significant bit of every b-bit field."""
    return sum(1 << (i * bits) for i in range(codes_per_word(bits)))


def fold_nonzero_fields(x: torch.Tensor, bits: int) -> torch.Tensor:
    """OR-fold each b-bit field of int64 ``x`` (uint32 values) onto its
    LSB: bit i*b of the result is 1 iff field i is nonzero."""
    s = 1
    while s < bits:
        x = x | (x >> s)
        s *= 2
    return x


def mismatch_count_words(xor_words: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-word count of differing b-bit fields of XORed words (int64
    uint32 values) -> int64."""
    folded = fold_nonzero_fields(xor_words, bits)
    return _popcount32(folded & field_lsb_mask(bits))


def bitmask_width(n: int) -> int:
    """Words in a packed one-bit-per-row validity mask over n rows."""
    return (n + 31) // 32


def pack_bitmask(flags: torch.Tensor) -> torch.Tensor:
    """Flags [..., n] -> int32 words [..., ceil(n/32)]: bit ``r % 32`` of
    word ``r // 32`` is set iff flag r is nonzero (``pack_codes`` at
    bits=1); bits past n are zero, which the masked kernels rely on."""
    return pack_codes((flags != 0).to(torch.int32), 1)


def unpack_bitmask(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pack_bitmask``: int32 words [..., W] -> bool [..., n]."""
    return unpack_codes(words, 1, n).to(torch.bool)


def match_count_packed(a: torch.Tensor, b: torch.Tensor, bits: int,
                       k: int) -> torch.Tensor:
    """Colliding b-bit codes between int32 word rows a, b [..., W] ->
    int32 [...]; zero-padded fields XOR to zero and never count."""
    xor = as_u32(a) ^ as_u32(b)
    return (k - mismatch_count_words(xor, bits).sum(dim=-1)).to(torch.int32)
