"""The word microbenchmark (scripts/micro_word.py, E3) vs the port, on the CPU.

The five Pallas bodies are closures inside the script's ``main()``; they are
pulled out with ``ast``, bound to a small shape (nb=2, R=64, ROW=128) and
run through ``pl.pallas_call(..., interpret=True)``.  Each must equal its
plain torch version in ``ops/micro_word.py`` and the CPU path of its kernel
wrapper exactly: the inputs are integers in -4..4, so every sum is an
integer (tolerance 0).
"""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hypersonic_rle_kit_tpu_torch.ops import micro_word as mw

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts/micro_word.py"
NB, R, ROW = 2, 64, 128
BODIES = {"body_slice_only": ("slice-only(bf16->f32 sum)", "word_slice_sum"),
          "body_slice_i32": ("slice-i32", "word_slice_sum"),
          "body_smalls": ("16 small matmuls", "word_sampled_prefix"),
          "body_fused4": ("4 fused [128,512]", "word_sampled_prefix"),
          "body_big1": ("1 big [512,512]", "word_sampled_prefix")}


@functools.cache
def _bodies() -> dict:
    """The script's E3 bodies, ``consts`` and ``mdn``, bound to the small
    shape."""
    tree = ast.parse(SCRIPT.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keep = [n for n in main.body
            if (isinstance(n, ast.FunctionDef)
                and (n.name == "consts" or n.name in BODIES))
            or (isinstance(n, ast.Assign)
                and [ast.unparse(t) for t in n.targets] == ["mdn"])]
    ns = {"jax": jax, "jnp": jnp, "R": R, "R4": R // 4, "ROW": ROW}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(SCRIPT), "exec"),
         ns)
    missing = set(BODIES) - set(ns)
    assert not missing, missing
    return ns


def _plane(seed: int) -> np.ndarray:
    """The script's painted plane at the small shape, as float32."""
    rng = np.random.default_rng(seed)
    return rng.integers(-4, 5, (NB, R, ROW), dtype=np.int64).astype(np.float32)


def _pallas(body, x: np.ndarray) -> np.ndarray:
    f = pl.pallas_call(
        body, grid=(NB,),
        in_specs=[pl.BlockSpec((1, R, ROW), lambda b: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, R // 4, ROW), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((NB, R // 4, ROW), jnp.int32),
        interpret=True)
    return np.asarray(f(jnp.asarray(x).astype(jnp.bfloat16)))


@pytest.mark.parametrize("body", sorted(BODIES))
def test_body_matches_plain_and_wrapper(body):
    x = _plane(0)
    want = _pallas(_bodies()[body], x)
    plain_name, wrapper = BODIES[body]
    xt = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(mw.PLAIN[plain_name](xt).numpy(), want)
    np.testing.assert_array_equal(getattr(mw, wrapper)(xt).numpy(), want)


def test_formulas():
    """The two functions as written in the kernel's header, in numpy."""
    x = _plane(1)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    v = x.reshape(NB, R // 4, 4, ROW)
    np.testing.assert_array_equal(mw.word_slice_sum(xt).numpy(),
                                  v.sum(2).astype(np.int32))
    c = np.arange(ROW)
    j, k = c >> 5, c & 31
    y = v[:, :, j, :]                        # [nb, R/4, c, row]
    taps = sum((4 - t) * np.take_along_axis(
        y, (4 * k + t)[None, None, :, None], 3)[..., 0] for t in range(4))
    np.testing.assert_array_equal(mw.word_sampled_prefix(xt).numpy(),
                                  taps.astype(np.int32))
    # every plain version of a function agrees on the same plane
    for name, fn in mw.PLAIN.items():
        want = (mw.word_slice_sum if "slice" in name
                else mw.word_sampled_prefix)(xt)
        assert torch.equal(fn(xt), want), name


@pytest.mark.parametrize("shape", [(3, 8, 5), (1, 4, 1), (2, 12, 129),
                                   (2, 12, 8)])
def test_slice_sum_odd_shapes(shape):
    """The plain versions take any shape; the wrapper only rows of whole
    4-element groups, as its kernel does."""
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-4, 5, shape).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    nb, r, row = shape
    want = x.reshape(nb, r // 4, 4, row).sum(2).astype(np.int32)
    np.testing.assert_array_equal(mw.slice_sum_f32(xt).numpy(), want)
    np.testing.assert_array_equal(mw.slice_sum_i32(xt).numpy(), want)
    if row % 4:
        with pytest.raises(ValueError):
            mw.word_slice_sum(xt)
    else:
        np.testing.assert_array_equal(mw.word_slice_sum(xt).numpy(), want)


def test_wrappers_reject_bad_input():
    x = torch.zeros((2, 8, ROW), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        mw.word_slice_sum(x.float())
    with pytest.raises(ValueError):
        mw.word_slice_sum(x[:, :6])
    with pytest.raises(ValueError):
        mw.word_sampled_prefix(x[:, :, :64].contiguous())
    with pytest.raises(ValueError):
        mw.word_sampled_prefix(torch.zeros((4, 4, ROW), dtype=torch.bfloat16)
                               .transpose(0, 1))
    with pytest.raises(ValueError):
        mw.word_slice_sum(x.to("meta"))
    flat = torch.zeros(2 * 8 * ROW + 8, dtype=torch.bfloat16)
    for off in (1, 4):                    # 2 and 8 bytes past a boundary
        with pytest.raises(ValueError):
            mw.word_sampled_prefix(flat[off:off + 2 * 8 * ROW]
                                   .view(2, 8, ROW))
    np.testing.assert_array_equal(           # 16 bytes: admitted
        mw.word_sampled_prefix(flat[8:8 + 2 * 8 * ROW].view(2, 8, ROW)),
        np.zeros((2, 2, ROW), np.int32))
