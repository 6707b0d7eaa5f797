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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,feat", [("uint8", ()), ("uint8", (68,)), ("uint8", (64, 64, 3)), ("float32", ()), ("float32", (17,)), ("float32", (3072,))])
def test_gather_kernel_bytes_exact(dtype, feat):
    """The window gather against per-key advanced indexing, bytes exact:
    rows of 1, 68 and 12,288 bytes (uint8) and 4, 68 and 12,288 bytes
    (f32), three envs, windows that wrap the ring, and all of them in one
    launch beside a key of another row size."""
    from sheeprl_tpu_torch.ops.gather import gather_windows, gather_windows_plain

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(len(feat))
    cap, n_envs, seq_len, batch, n_samples = 97, 3, 16, 5, 2
    shape = (cap, n_envs, *feat)
    if dtype == "uint8":
        ring = torch.randint(0, 256, shape, generator=g, device="cuda", dtype=torch.uint8)
    else:
        ring = torch.randn(shape, generator=g, device="cuda")
    bufs = {"x": ring, "flag": torch.randn((cap, n_envs, 1), generator=g, device="cuda")}
    flat = n_samples * batch
    starts = torch.randint(0, cap, (flat,), generator=g, device="cuda", dtype=torch.int32)
    starts[:3] = torch.tensor([cap - 1, cap - 5, cap - seq_len + 1], dtype=torch.int32, device="cuda")
    envs = torch.randint(0, n_envs, (flat,), generator=g, device="cuda", dtype=torch.int32)
    before = gather_windows.launches
    out = gather_windows(bufs, starts, envs, seq_len=seq_len, batch_size=batch)
    ref = gather_windows_plain(bufs, starts, envs, seq_len=seq_len, batch_size=batch)
    torch.cuda.synchronize()
    assert gather_windows.launches == before + 1
    for k in bufs:
        assert out[k].shape == (n_samples, seq_len, batch, *bufs[k].shape[2:]) and out[k].dtype == bufs[k].dtype
        assert torch.equal(out[k], ref[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [16, 1024])
def test_gru_backward_matches_plain_autograd(batch):
    """The training op's gradients (kernel forward, plain-formula backward)
    against autograd through the plain version at the XL widths, at the
    dynamic scan's B = 16 and imagination's B = 1024: within 1e-4 of each
    gradient's largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    hidden, xdim = 4096, 1024
    g = torch.Generator(device="cuda").manual_seed(batch)
    leaves = (
        torch.tanh(torch.randn(batch, hidden, device="cuda", generator=g)).requires_grad_(),
        torch.randn(batch, xdim, device="cuda", generator=g).requires_grad_(),
        (torch.randn(hidden + xdim, 3 * hidden, device="cuda", generator=g) * (hidden + xdim) ** -0.5).requires_grad_(),
        (1 + 0.1 * torch.randn(3 * hidden, device="cuda", generator=g)).requires_grad_(),
        (0.1 * torch.randn(3 * hidden, device="cuda", generator=g)).requires_grad_(),
    )
    up = torch.randn(batch, hidden, device="cuda", generator=g)
    before = gru_cell.launches
    got = torch.autograd.grad(gru_cell(*leaves), leaves, up)
    ref = torch.autograd.grad(gru_cell_plain(*leaves), leaves, up)
    torch.cuda.synchronize()
    assert gru_cell.launches == before + 1
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
