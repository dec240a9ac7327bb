"""Uniform codec dispatch — the analog of the reference's ``codecCallbacks``
table (codec_funcs.h:270-410): every codec exposed as
``compress(data, spec) -> bytes`` / ``decompress(buf, spec) -> bytes``."""

from __future__ import annotations

from ..spec import CodecSpec, Family, by_index, by_name
from . import low_entropy, lut, mmtf, rle8, rle8_mmtf, rle128, rlex, sh, short


def _resolve(spec) -> CodecSpec:
    if isinstance(spec, CodecSpec):
        return spec
    if isinstance(spec, int):
        return by_index(spec)
    return by_name(spec)


def compress(data, spec) -> bytes:
    """Reference-format compress for any of the 120 codecs."""
    s = _resolve(spec)
    f = s.family
    if f is Family.RLE8:
        return rle8.rle8_compress(data, packed=s.packed, single=s.single)
    if f is Family.RLEX:
        if s.width == 128:
            return rle128.rle128_compress(data, byte_aligned=s.byte_aligned,
                                          packed=s.packed)
        return rlex.rlex_compress(data, s.width, byte_aligned=s.byte_aligned,
                                  packed=s.packed)
    if f is Family.LUT:
        return lut.lut_compress(data, s.width, s.lut,
                                byte_aligned=s.byte_aligned)
    if f is Family.SHORT:
        return short.short_compress(data, s.width, s.lut,
                                    byte_aligned=s.byte_aligned,
                                    single=s.single, greedy=s.greedy)
    if f is Family.SH:
        return sh.sh_compress(data)
    if f is Family.RLE8_MMTF:
        return rle8_mmtf.mmtf_rle_compress(data)
    if f in (Family.LOW_ENTROPY, Family.LOW_ENTROPY_SHORT):
        return low_entropy.le_compress(data, short=s.short, single=s.single)
    if f is Family.MMTF:
        return (mmtf.mmtf128_encode if s.width == 128
                else mmtf.mmtf256_encode)(data)
    if f is Family.BIT_MMTF:
        return (mmtf.bitmmtf8_encode if s.width == 8
                else mmtf.bitmmtf16_encode)(data)
    if f is Family.MEMCPY:
        return bytes(data)
    raise ValueError(f"unknown family {f}")


def decompress(buf, spec) -> bytes:
    """Reference-format decompress for any of the 120 codecs."""
    s = _resolve(spec)
    f = s.family
    if f is Family.RLE8:
        return rle8.rle8_decompress(buf, packed=s.packed)
    if f is Family.RLEX:
        if s.width == 128:
            return rle128.rle128_decompress(buf, byte_aligned=s.byte_aligned,
                                            packed=s.packed)
        return rlex.rlex_decompress(buf, s.width, byte_aligned=s.byte_aligned,
                                    packed=s.packed)
    if f is Family.LUT:
        return lut.lut_decompress(buf, s.width, s.lut,
                                  byte_aligned=s.byte_aligned)
    if f is Family.SHORT:
        return short.short_decompress(buf, s.width, s.lut,
                                      byte_aligned=s.byte_aligned,
                                      single=s.single)
    if f is Family.SH:
        return sh.sh_decompress(buf)
    if f is Family.RLE8_MMTF:
        return rle8_mmtf.mmtf_rle_decompress(buf)
    if f in (Family.LOW_ENTROPY, Family.LOW_ENTROPY_SHORT):
        return low_entropy.le_decompress(buf, short=s.short)
    if f is Family.MMTF:
        return (mmtf.mmtf128_decode if s.width == 128
                else mmtf.mmtf256_decode)(buf)
    if f is Family.BIT_MMTF:
        return (mmtf.bitmmtf8_decode if s.width == 8
                else mmtf.bitmmtf16_decode)(buf)
    if f is Family.MEMCPY:
        return bytes(buf)
    raise ValueError(f"unknown family {f}")
