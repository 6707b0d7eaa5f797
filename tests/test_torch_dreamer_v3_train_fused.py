"""The port's train step with ``recurrent_model.fused=True`` against the
JAX package's, and the GRU op's gradients against the fused Pallas cell's.

With ``fused=True`` every GRU step of the JAX train step runs through
``pallas_gru.gru_cell`` (Pallas forward in interpret mode on the CPU, XLA
backward ``_gru_bwd``); the port's runs through its autograd op (the plain
version on the CPU, backward through the two-pass formulas).  The same
two steps as ``test_torch_dreamer_v3_train.py``, at the same tolerances;
the op's forward to 1e-5 (``tests/test_parallel/test_pallas_gru.py``'s
tolerance) and its gradients to 1e-5 of each gradient's largest magnitude
(both differentiate the same f32 formulas).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops.pallas_gru import gru_cell as pallas_gru_cell
from sheeprl_tpu_torch.ops.gru_cell import gru_cell

from test_torch_dreamer_v3_train import run_and_compare, tiny_train_pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_step_matches_jax_fused_gru():
    run_and_compare(tiny_train_pair(fused=True))


@pytest.mark.parametrize("b,hidden,xdim", [(4, 128, 128), (16, 128, 256)])
def test_gru_gradients_match_pallas_custom_vjp(b, hidden, xdim):
    rng = np.random.default_rng(b)
    args = [
        np.tanh(rng.normal(size=(b, hidden))),
        rng.normal(size=(b, xdim)),
        rng.normal(scale=(hidden + xdim) ** -0.5, size=(hidden + xdim, 3 * hidden)),
        1 + 0.1 * rng.normal(size=(3 * hidden,)),
        0.1 * rng.normal(size=(3 * hidden,)),
    ]
    args = [a.astype(np.float32) for a in args]
    up = rng.normal(size=(b, hidden)).astype(np.float32)

    def f(h, x, w, g, bb):
        return pallas_gru_cell(h, x, w, g, bb, 1e-6, True, 8, 512, True, jnp.float32)

    out_j, vjp = jax.vjp(f, *map(jnp.asarray, args))
    grads_j = vjp(jnp.asarray(up))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = gru_cell(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(up))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    for name, a, ref in zip(("h", "x", "w", "gamma", "beta"), grads, grads_j):
        ref = np.asarray(ref)
        assert np.abs(a.numpy() - ref).max() <= 1e-5 * np.abs(ref).max(), name
