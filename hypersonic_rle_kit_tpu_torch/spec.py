"""Codec specification registry.

The reference library (`src/codec_funcs.h:4-133`) enumerates 121
codecs produced by a C-preprocessor macro matrix (`TYPE_SIZE`, `UNBOUND`,
`PACKED`, `SYMBOL_COUNT`, `SINGLE`, `SHORT`, greedy encoders).  Here that matrix
becomes data: a :class:`CodecSpec` dataclass and a registry built by expanding
the same parameter space, in the exact enum order of the reference so codec
indices are interchangeable with `codec_t` (codec_funcs.h:4-133) and names match
`codecNames[]` (codec_funcs.h:135-258).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Family(enum.Enum):
    """Top-level codec family (reference layer L2, SURVEY.md section 2.2)."""

    RLE8 = "rle8"              # rle8_extreme_cpu.{c,h}: base/packed x multi/single
    RLEX = "rlex"              # rleX/rle24/rle48/rle128_extreme_cpu*: generic widths
    LUT = "lut"                # rleX_Xsl.{c,h}: 3/7-symbol MTF LUT, 16-bit headers
    SHORT = "short"            # rleX_Xsl_short.{c,h}: 0/1/3/7 LUT, 1-byte commands
    SH = "sh"                  # rle_sh.c: RLE + Huffman-esque bitstream
    RLE8_MMTF = "rle8_mmtf"    # rle8_mmtf.c: MTF blocks + bitpacking
    LOW_ENTROPY = "low_entropy"        # rle8_low_entropy_cpu.c
    LOW_ENTROPY_SHORT = "low_entropy_short"  # rle8_low_entropy_short_cpu.c
    MMTF = "mmtf"              # mmtf.c: Multi Move-To-Front transform (ratio 1.0)
    BIT_MMTF = "bit_mmtf"      # bit_mmtf.c: per-bit-position xor predictor
    MEMCPY = "memcpy"          # benchmark control row


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """One codec variant = one row of the reference's `codecCallbacks[]` table.

    Field semantics mirror the reference's macro parameters:

    - ``width``: symbol width in bits (TYPE_SIZE). 8/16/24/32/48/64/128.
    - ``byte_aligned``: run lengths counted in bytes with partial-symbol tails
      (the reference's ``UNBOUND`` / "(Byte)" codecs, rleX_extreme_cpu_encode.h:114-164).
    - ``packed``: same-symbol bit + elided symbol + 7-bit/4-byte copy varints
      (rle8_extreme_cpu.h:832-853 for the 8-bit layout).
    - ``lut``: recent-distinct-symbol MTF LUT size: 0, 1, 3 or 7 (SYMBOL_COUNT).
    - ``short``: one-byte command headers (rleX_Xsl_short.h:13-42).
    - ``single``: single best RLE symbol chosen up front (SINGLE).
    - ``greedy``: encoder additionally matches partial prefixes of LUT symbols
      (rleX_Xsl_short.h:746-1000); decoder is shared with the non-greedy Short.
    """

    index: int                     # codec_t enum value
    name: str                      # codecNames[] entry, stripped
    family: Family
    width: int = 8                 # symbol width in bits
    byte_aligned: bool = False     # "(Byte)" / UNBOUND
    packed: bool = False
    lut: int = 0                   # 0 (none), 1, 3 or 7
    short: bool = False
    single: bool = False
    greedy: bool = False

    @property
    def symbol_bytes(self) -> int:
        return self.width // 8

    @property
    def is_transform(self) -> bool:
        """Transforms are 1:1 recodings (ratio 1.0), not compressors."""
        return self.family in (Family.MMTF, Family.BIT_MMTF)

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return f"CodecSpec#{self.index}({self.name!r})"


def _build_registry() -> list[CodecSpec]:
    specs: list[CodecSpec] = []

    def add(name: str, family: Family, **kw) -> None:
        specs.append(CodecSpec(index=len(specs), name=name, family=family, **kw))

    # -- 8 bit family (rle8_extreme_cpu.c + rleX_Xsl*.c 8-bit instantiations) --
    add("8 Bit", Family.RLE8, width=8)
    add("8 Bit Short", Family.SHORT, width=8, lut=0, short=True)
    add("8 Bit Packed", Family.RLE8, width=8, packed=True)
    add("8 Bit 1LUT Short", Family.SHORT, width=8, lut=1, short=True)
    add("8 Bit 3LUT", Family.LUT, width=8, lut=3)
    add("8 Bit 3LUT Short", Family.SHORT, width=8, lut=3, short=True)
    add("8 Bit 7LUT", Family.LUT, width=8, lut=7)
    add("8 Bit 7LUT Short", Family.SHORT, width=8, lut=7, short=True)
    add("8 Bit Single", Family.RLE8, width=8, single=True)
    add("8 Bit Single Short", Family.SHORT, width=8, lut=0, short=True, single=True)
    add("8 Bit Single Packed", Family.RLE8, width=8, packed=True, single=True)

    # -- 16/24/32/48/64 bit families ------------------------------------------
    for width in (16, 24, 32, 48, 64):
        for aligned, tag in ((False, "(Symbol)"), (True, "(Byte)")):
            w = f"{width} Bit"
            add(f"{w} {tag}", Family.RLEX, width=width, byte_aligned=aligned)
            add(f"{w} Short {tag}", Family.SHORT, width=width, byte_aligned=aligned,
                lut=0, short=True)
            add(f"{w} Packed {tag}", Family.RLEX, width=width, byte_aligned=aligned,
                packed=True)
            add(f"{w} 1LUT Short {tag}", Family.SHORT, width=width,
                byte_aligned=aligned, lut=1, short=True)
            if aligned:
                add(f"{w} 1LUT Short Grdy (Byte)", Family.SHORT, width=width,
                    byte_aligned=True, lut=1, short=True, greedy=True)
            add(f"{w} 3LUT {tag}", Family.LUT, width=width, byte_aligned=aligned,
                lut=3)
            add(f"{w} 3LUT Short {tag}", Family.SHORT, width=width,
                byte_aligned=aligned, lut=3, short=True)
            if aligned:
                add(f"{w} 3LUT Short Grdy (Byte)", Family.SHORT, width=width,
                    byte_aligned=True, lut=3, short=True, greedy=True)
            add(f"{w} 7LUT {tag}", Family.LUT, width=width, byte_aligned=aligned,
                lut=7)
            add(f"{w} 7LUT Short {tag}", Family.SHORT, width=width,
                byte_aligned=aligned, lut=7, short=True)
            if aligned:
                add(f"{w} 7LUT Short Grdy (Byte)", Family.SHORT, width=width,
                    byte_aligned=True, lut=7, short=True, greedy=True)

    # -- 128 bit family (rle128_extreme_cpu.{c,h}) ----------------------------
    add("128 Bit (Symbol)", Family.RLEX, width=128)
    add("128 Bit Packed (Symbol)", Family.RLEX, width=128, packed=True)
    add("128 Bit (Byte)", Family.RLEX, width=128, byte_aligned=True)
    add("128 Bit Packed (Byte)", Family.RLEX, width=128, byte_aligned=True,
        packed=True)

    # -- specials -------------------------------------------------------------
    add("8 Bit RLE + Huffman-esque", Family.SH, width=8)
    add("8 Bit MMTF 128", Family.RLE8_MMTF, width=8)
    add("Low Entropy", Family.LOW_ENTROPY, width=8)
    add("Low Entropy Single", Family.LOW_ENTROPY, width=8, single=True)
    add("Low Entropy Short", Family.LOW_ENTROPY_SHORT, width=8, short=True)
    add("Low Entropy Short Single", Family.LOW_ENTROPY_SHORT, width=8, short=True,
        single=True)
    add("Multi MTF 128 Bit (Transform)", Family.MMTF, width=128)
    add("Multi MTF 256 Bit (Transform)", Family.MMTF, width=256)
    add("Bit MMTF 8 Bit (Transform)", Family.BIT_MMTF, width=8)
    add("Bit MMTF 16 Bit (Transform)", Family.BIT_MMTF, width=16)
    add("memcpy", Family.MEMCPY, width=8)

    return specs


REGISTRY: tuple[CodecSpec, ...] = tuple(_build_registry())
CODEC_COUNT = len(REGISTRY)

_BY_NAME = {spec.name: spec for spec in REGISTRY}


def by_index(index: int) -> CodecSpec:
    return REGISTRY[index]


def by_name(name: str) -> CodecSpec:
    """Resolve a codec by its (whitespace-stripped) reference display name."""
    return _BY_NAME[" ".join(name.split())]


def find(
    family: Optional[Family] = None,
    width: Optional[int] = None,
    byte_aligned: Optional[bool] = None,
    packed: Optional[bool] = None,
    lut: Optional[int] = None,
    short: Optional[bool] = None,
    single: Optional[bool] = None,
    greedy: Optional[bool] = None,
) -> list[CodecSpec]:
    """Filter the registry; the analog of the CLI's `CodecMatchesArgs`
    (main.c:1690+)."""
    out = []
    for spec in REGISTRY:
        if family is not None and spec.family is not family:
            continue
        if width is not None and spec.width != width:
            continue
        if byte_aligned is not None and spec.byte_aligned != byte_aligned:
            continue
        if packed is not None and spec.packed != packed:
            continue
        if lut is not None and spec.lut != lut:
            continue
        if short is not None and spec.short != short:
            continue
        if single is not None and spec.single != single:
            continue
        if greedy is not None and spec.greedy != greedy:
            continue
        out.append(spec)
    return out
