"""Reference-exact bitstream codecs (host side).

Each module implements one codec family's byte-level format, producing output
byte-identical to the reference C library (validated against golden vectors in
``tests/``).  These are the "golden" slow paths: correctness anchors for the
device kernels in :mod:`hypersonic_rle_kit_tpu_torch.ops` and the interop
layer for consuming/producing reference-format streams.  The port's own
copy of the JAX package's ``formats``: the same bytes out.

The hot loops here are vectorized with numpy over *runs* (symbol-change
boundaries), not bytes, so they stay usable for multi-megabyte test inputs.
"""

from .rle8 import (  # noqa: F401
    rle8_compress,
    rle8_decompress,
    compress_bounds,
    decompress_additional_size,
)
from .registry import compress, decompress  # noqa: F401
