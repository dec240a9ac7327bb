"""Torch ops of the HRT1 encode and decode paths and their Hopper kernels.

Modules (each mirrors the JAX module of the same name):
    planar         columnar command IR + numpy host goldens
    device         plain torch block encode/decode
    encode_sup     bytes -> planar columns (kernel hrt1_encode)
    decode_sup     planar columns -> bytes (kernel hrt1_decode), width
                   re-interleave in the words form
    unpack_device  payload sections -> columns (kernel hrt1_resolve_deep)
    _kernels       nvcc build + ctypes loader for ../csrc/*.cu
"""
