"""The port's hand-written CUDA kernels against their plain versions.

These tests need a CUDA device (a kernel has no CPU mode) and skip without
one.  They import only torch and the port, so they run where JAX is not
installed; on a machine with a card run them without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from sheeprl_tpu_torch.ops.gru_cell import gru_cell, gru_cell_plain


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden,xdim", [(1, 4096, 1024), (7, 4096, 1024), (64, 4096, 1024), (3, 40, 24)])
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(batch, hidden, xdim, wdtype):
    """The CUDA kernel against its plain version on the card: at the XL
    widths the serving path gives it (H=4096, X=1024), and at a width that
    leaves most of a column block and of a K chunk empty."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(batch)
    h = torch.randn(batch, hidden, device="cuda", generator=g)
    x = torch.randn(batch, xdim, device="cuda", generator=g)
    w = (torch.randn(hidden + xdim, 3 * hidden, device="cuda", generator=g) * (hidden + xdim) ** -0.5).to(getattr(torch, wdtype))
    gamma = 1 + 0.1 * torch.randn(3 * hidden, device="cuda", generator=g)
    beta = 0.1 * torch.randn(3 * hidden, device="cuda", generator=g)
    tol = 2e-5 if wdtype == "float32" else 2e-3
    for two_pass in (True, False):
        out = gru_cell(h, x, w, gamma, beta, two_pass=two_pass)
        ref = gru_cell_plain(h, x, w, gamma, beta, two_pass=two_pass)
        torch.cuda.synchronize()
        assert (out - ref).abs().max().item() <= tol
