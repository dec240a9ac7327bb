"""Multi-device / multi-host distribution of the block codec on
``torch.distributed`` (port of :mod:`hypersonic_rle_kit_tpu.parallel`).

The HRT1 container (:mod:`.container`) is the port's own copy of the JAX
package's, byte for byte the same format.
"""
