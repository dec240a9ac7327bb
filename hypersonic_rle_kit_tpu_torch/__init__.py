"""hypersonic-rle-kit on PyTorch and CUDA (Hopper).

The port of the JAX/Pallas package :mod:`hypersonic_rle_kit_tpu`, which
stays the reference.  The port imports nothing of that package: it keeps
its own copies of the host modules both use, byte for byte the same
behaviour (the tests hold each copy against its original):

- :mod:`spec`, :mod:`formats` -- the codec registry and the 121
  reference-exact codecs; :mod:`~hypersonic_rle_kit_tpu_torch.parallel.container`
  -- HRT1 parse, serialize and ``pack_for_device``;
  :mod:`~hypersonic_rle_kit_tpu_torch.utils.native` -- the C++ host
  runtime (``csrc/hsrk_host.cpp``, built into ``build/torch_host/``);
  :mod:`~hypersonic_rle_kit_tpu_torch.datasets` -- the benchmark corpora.
- :mod:`~hypersonic_rle_kit_tpu_torch.ops` -- torch tensor ops and the
  hand-written Hopper kernels (``csrc/*.cu``) of the HRT1 encode and
  decode paths, the reference-format and Low Entropy decoders, MMTF and
  the word microbenchmark.
- :mod:`~hypersonic_rle_kit_tpu_torch.api` -- ``compress`` / ``decompress``.
- :mod:`~hypersonic_rle_kit_tpu_torch.parallel` -- the block axis over
  every card of one process (a ``LocalMesh``) or over ``torch.distributed``
  ranks (size exchange, ordered reassembly).
- :mod:`~hypersonic_rle_kit_tpu_torch.graft_entry`,
  :mod:`~hypersonic_rle_kit_tpu_torch.fuzz`,
  :mod:`~hypersonic_rle_kit_tpu_torch.bench_cli` -- the decode step and the
  multi-rank dry run, the device fuzz lane, the benchmark CLI.

Importing the package touches no CUDA state and imports no JAX.
"""

__version__ = "0.1.0"

from . import formats, spec  # noqa: F401
