"""The port's LayerNorm-GRU step against the JAX package's.

The port's plain version (``sheeprl_tpu_torch/ops/gru_cell.py``) is held
against the fused Pallas kernel in interpret mode, its pure-jax reference
and the flax cell's unfused formula, on the same numpy inputs, at the
tolerance the JAX package holds its own kernel to (1e-5).  The CUDA kernel
itself runs only on the card: ``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.models.models import gru_cell_apply
from sheeprl_tpu.ops.pallas_gru import fused_gru_cell, reference_gru_cell
from sheeprl_tpu_torch.ops.gru_cell import gru_cell, gru_cell_plain, split_k

SHAPES = [(4, 128, 128), (3, 128, 256), (8, 256, 640)]  # tests/test_parallel/test_pallas_gru.py:13


def _inputs(b, hidden, xdim, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(b, hidden)).astype(np.float32)
    x = rng.normal(size=(b, xdim)).astype(np.float32)
    w = rng.normal(scale=0.1, size=(hidden + xdim, 3 * hidden)).astype(np.float32)
    gamma = rng.normal(size=(3 * hidden,)).astype(np.float32)
    beta = rng.normal(scale=0.1, size=(3 * hidden,)).astype(np.float32)
    return h, x, w, gamma, beta


def _jax_oracle(name, h, x, w, gamma, beta):
    j = [jnp.asarray(a) for a in (h, x, w, gamma, beta)]
    if name == "fused_gru_cell":
        return fused_gru_cell(*j, block_b=4, block_k=128, interpret=True)
    if name == "reference_gru_cell":
        return reference_gru_cell(*j)
    params = {"Dense_0": {"kernel": j[2]}, "LayerNorm_0": {"scale": j[3], "bias": j[4]}}
    return gru_cell_apply(params, j[0], j[1], fused=False)


@pytest.mark.parametrize("b,hidden,xdim", SHAPES)
@pytest.mark.parametrize("oracle", ["fused_gru_cell", "reference_gru_cell", "gru_cell_apply_unfused"])
def test_plain_gru_matches_jax(b, hidden, xdim, oracle):
    """Two-pass LayerNorm against the fused kernel and its reference; the
    flax cell's fast variance against ``gru_cell_apply(fused=False)``."""
    args = _inputs(b, hidden, xdim)
    ref = np.asarray(_jax_oracle(oracle, *args))
    out = gru_cell_plain(*map(torch.from_numpy, args), two_pass=oracle != "gru_cell_apply_unfused")
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,hidden,xdim", SHAPES[:2])
def test_plain_gru_bf16_operands_match_pallas(b, hidden, xdim):
    """bf16 operands with f32 sums: both sides round [h | x] and W to bf16
    the same way and products of bf16 values are exact in f32, so only the
    summation order differs (1e-5 holds)."""
    h, x, w, gamma, beta = _inputs(b, hidden, xdim, seed=3)
    ref = fused_gru_cell(
        *map(jnp.asarray, (h, x, w, gamma, beta)), block_b=4, block_k=128, interpret=True,
        matmul_dtype=jnp.bfloat16,
    )
    out = gru_cell_plain(
        torch.from_numpy(h), torch.from_numpy(x), torch.from_numpy(w).to(torch.bfloat16),
        torch.from_numpy(gamma), torch.from_numpy(beta),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    args = [torch.from_numpy(a) for a in _inputs(4, 128, 128, seed=5)]
    before = gru_cell.launches
    out = gru_cell(*args)
    assert gru_cell.launches == before  # no kernel launched for CPU tensors
    torch.testing.assert_close(out, gru_cell_plain(*args), rtol=0, atol=0)


@pytest.mark.parametrize("batch", [1, 7, 64, 200])
def test_split_k_covers_k_in_whole_chunks(batch):
    """The kernel's K split at DV3-XL widths: slices are whole 32-row
    chunks, cover K exactly once, and give every SM of an H100 blocks."""
    hidden, kdim, sms = 4096, 5120, 132
    ks, n_split = split_k(batch, hidden, kdim, sms)
    assert ks % 32 == 0
    assert (n_split - 1) * ks < kdim <= n_split * ks
    rows = min(16, 1 << (batch - 1).bit_length())
    blocks = -(-batch // rows) * (3 * hidden // 1024) * n_split
    assert blocks >= sms
