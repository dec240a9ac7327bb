"""Multi-device / multi-host distribution of the block codec on
``torch.distributed`` (port of :mod:`hypersonic_rle_kit_tpu.parallel`).

The HRT1 container itself (:mod:`hypersonic_rle_kit_tpu.parallel.container`)
imports no JAX and is shared, not ported.
"""
