"""hypersonic-rle-kit on PyTorch and CUDA (Hopper).

The port of the JAX/Pallas package :mod:`hypersonic_rle_kit_tpu`, which
stays the reference.  The jax-free host modules (codec registry, reference
formats, HRT1 container, native host runtime) are shared, not copied:

- :mod:`spec`, :mod:`formats` -- re-exported from the JAX package.
- :mod:`~hypersonic_rle_kit_tpu_torch.ops` -- torch tensor ops and the
  hand-written Hopper kernels (``csrc/*.cu``) of the HRT1 encode and
  decode paths, the reference-format and Low Entropy decoders, MMTF and
  the word microbenchmark.
- :mod:`~hypersonic_rle_kit_tpu_torch.api` -- ``compress`` / ``decompress``.
- :mod:`~hypersonic_rle_kit_tpu_torch.parallel` -- the block axis over
  ``torch.distributed`` ranks (size exchange, ordered reassembly).
- :mod:`~hypersonic_rle_kit_tpu_torch.graft_entry`,
  :mod:`~hypersonic_rle_kit_tpu_torch.fuzz`,
  :mod:`~hypersonic_rle_kit_tpu_torch.bench_cli` -- the decode step and the
  multi-rank dry run, the device fuzz lane, the benchmark CLI.

Importing the package touches no CUDA state and imports no JAX.
"""

__version__ = "0.1.0"

from hypersonic_rle_kit_tpu import formats, spec  # noqa: F401
