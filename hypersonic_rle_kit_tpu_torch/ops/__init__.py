"""Torch ops of the port's device paths and their Hopper kernels.

Modules (each mirrors the JAX module of the same name, where it has one):
    planar              columnar command IR + numpy host goldens
    device              plain torch block encode/decode
    encode_sup          bytes -> planar columns (kernel hrt1_encode)
    decode_sup          planar columns -> bytes (kernel hrt1_decode), width
                        re-interleave in the words form
    unpack_device       payload sections -> columns (kernel hrt1_resolve_deep)
    ref_device          reference-format streams -> planar -> hrt1_decode
    low_entropy_device  Low Entropy / rle8m -> planar -> hrt1_decode
    mmtf_device         MMTF 128/256 (kernel mmtf_scan) and Bit-MMTF
    bitpack             1..8-bit pack / unpack (plain torch)
    micro_word          the word microbenchmark's slice-sum and sampled
                        prefix (kernels word_slice_sum, word_sampled_prefix)
    transfer            pinned host <-> device copies
    _kernels            nvcc build + ctypes loader for ../csrc/*.cu
"""
