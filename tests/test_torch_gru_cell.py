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
from sheeprl_tpu_torch.ops.gru_cell import gru_cell, gru_cell_plain, split_k, tile_depth, tile_rows

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


@pytest.mark.parametrize("hidden,xdim", [(4096, 1024), (512, 512)])
@pytest.mark.parametrize("batch", [1, 7, 16, 64, 100, 129, 200, 1024])
def test_split_k_covers_k_in_whole_chunks(batch, hidden, xdim):
    """The product kernel's tiles at DV3-XL and DV3-S widths: a block's
    rows are one MMA tile up to B = 16, the K slices are whole tiles (64
    rows for 128-row blocks, else 32) of the h and then the x segment and
    cover them exactly once, and every SM of an H100 gets a block (at most
    8 a SM)."""
    sms = 132
    bm, ts, n_split = split_k(batch, hidden, xdim, sms)
    assert bm == tile_rows(batch, hidden, sms)
    assert bm in (16, 64, 128) and (bm == 16) == (batch <= 16)
    depth = tile_depth(bm)
    assert depth == (64 if bm == 128 else 32)
    tiles = -(-hidden // depth) + -(-xdim // depth)
    assert (n_split - 1) * ts < tiles <= n_split * ts
    assert ts >= 2
    blocks = -(-batch // bm) * -(-3 * hidden // 128) * n_split
    assert blocks >= sms
    assert blocks <= 8 * sms
    if batch == 1024:
        assert (bm, n_split) == ((128, 1) if hidden == 4096 else (64, 2))


def _tf32(t: torch.Tensor, nearest: bool = True) -> torch.Tensor:
    """f32 cut to TF32's 10 mantissa bits: to nearest with ties away from
    zero (``cvt.rna.tf32.f32``), or truncated (the kernel's mask, and how the
    tensor cores read a .tf32 operand's low bits)."""
    bits = t.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _ln_gates64(parts, h, gamma, beta, eps=1e-6):
    mean = parts.mean(-1, keepdim=True)
    var = ((parts - mean) ** 2).mean(-1, keepdim=True)
    parts = (parts - mean) / torch.sqrt(var + eps) * gamma + beta
    hidden = h.shape[-1]
    reset = torch.sigmoid(parts[:, :hidden])
    cand = torch.tanh(reset * parts[:, hidden : 2 * hidden])
    update = torch.sigmoid(parts[:, 2 * hidden :] - 1.0)
    return update * cand + (1.0 - update) * h


@pytest.mark.parametrize("cut", ["nearest", "truncated"])
def test_3xtf32_product_holds_the_f32_tolerance(cut):
    """The f32 route's product on the tensor cores, emulated on the CPU:
    each operand split into big = tf32(a) and small = tf32(a - big), both
    rounded to nearest (``cvt.rna``) or both truncated (the kernel: its
    split masks big, and the tensor cores read small's upper 19 bits), the
    three products a_small b_big + a_big b_small + a_big b_big summed in
    f32, at K = 5120 (the DV3-XL depth).  After the LayerNorm and gates it
    stays within the kernel's f32 tolerance (2e-5) of the f64 step; one
    TF32 pass alone does not."""
    tol = 2e-5  # chip_smoke.py TOL["float32"], tests/test_torch_cuda_kernels.py
    b, hidden, xdim = 16, 512, 4608
    g = torch.Generator().manual_seed(0)
    h = torch.tanh(torch.randn(b, hidden, generator=g))
    x = torch.randn(b, xdim, generator=g)
    w = torch.randn(hidden + xdim, 3 * hidden, generator=g) * (hidden + xdim) ** -0.5
    gamma = 1 + 0.1 * torch.randn(3 * hidden, generator=g)
    beta = 0.1 * torch.randn(3 * hidden, generator=g)
    a = torch.cat([h, x], -1)
    nearest = cut == "nearest"
    a_big, w_big = _tf32(a, nearest), _tf32(w, nearest)
    a_small, w_small = _tf32(a - a_big, nearest), _tf32(w - w_big, nearest)
    three = a_small @ w_big + a_big @ w_small + a_big @ w_big
    one = a_big @ w_big
    args64 = [t.double() for t in (h, gamma, beta)]
    ref = _ln_gates64(a.double() @ w.double(), *args64)
    err3 = (_ln_gates64(three.double(), *args64) - ref).abs().max().item()
    err1 = (_ln_gates64(one.double(), *args64) - ref).abs().max().item()
    assert err3 <= tol, err3
    assert err1 > 10 * tol, err1


# The unfused cell under bf16 rounds each product sum to bf16 before the
# LayerNorm (``parts = inp.astype(bf16) @ kernel.astype(bf16)``, then f32).
# The f32 sums of the two sides agree to about 1e-6 relative, and one bf16
# ulp is 2^-8 relative, so only a rare sum lands on the other side of a
# rounding boundary: there the output moves by about one bf16 ulp of that
# normalised part (up to 2^-7 of it, through gates whose slopes are at most
# 1).  Everywhere else the two sides agree to f32 rounding.
BF16_FLIP_FRACTION = 0.01  # outputs allowed beyond BF16_ATOL
BF16_ATOL = 1e-5
BF16_MAX_ABS = 2.0**-7 * 8  # one ulp of a normalised part of |value| < 8


@pytest.mark.parametrize("b,hidden,xdim", SHAPES)
def test_unfused_bf16_cell_rounds_parts_like_jax(b, hidden, xdim):
    """``LayerNormGRUCell(fused=False, dtype=bf16)`` against
    ``gru_cell_apply(fused=False, dtype=bf16)`` with JAX's parameters
    carried over: the product is rounded to bf16 before the LayerNorm on
    both sides."""
    from sheeprl_tpu_torch.models.models import LayerNormGRUCell

    h, x, w, gamma, beta = _inputs(b, hidden, xdim, seed=7)
    params = {"Dense_0": {"kernel": jnp.asarray(w)}, "LayerNorm_0": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}
    ref = np.asarray(gru_cell_apply(params, jnp.asarray(h), jnp.asarray(x), fused=False, dtype=jnp.bfloat16))
    cell = LayerNormGRUCell(xdim, hidden, fused=False, dtype=torch.bfloat16)
    with torch.no_grad():
        cell.weight.copy_(torch.from_numpy(w))
        cell.norm.weight.copy_(torch.from_numpy(gamma))
        cell.norm.bias.copy_(torch.from_numpy(beta))
        out = cell(torch.from_numpy(h), torch.from_numpy(x)).numpy()
    diff = np.abs(out - ref)
    assert (diff > BF16_ATOL).mean() <= BF16_FLIP_FRACTION, f"{(diff > BF16_ATOL).mean():.3f} of outputs differ, max {diff.max()}"
    assert diff.max() <= BF16_MAX_ABS
