"""The port's sequence LayerNorm-GRU op and the decoupled RSSM's methods
against the JAX package's.

- The op: the plain version against ``gru_sequence_reference`` and against
  the Pallas ``gru_sequence`` in interpret mode (as
  ``tests/test_parallel/test_seq_gru.py`` runs it), at H = X = 128 with
  resets mid-sequence, at an even and an odd batch; the autograd op's
  backward (the efficient BPTT) against ``jax.grad`` through JAX's custom
  VJP for every differentiable input.
- The RSSM: ``recurrent_features_seq`` and ``gru_step_gated`` against the
  flax methods on converted parameters; ``gru_sequence_gated`` against a
  loop of ``gru_step_gated``; ``seq_scan_eligible`` against JAX's rule.

Tolerances, f32: forward values 1e-5 (the tolerance the JAX package holds
its sequence kernel to); gradients rtol 2e-4 / atol 2e-5, the tolerances of
``test_seq_gru.py``'s own gradient check (two BPTT formulations that sum in
different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.ops.seq_gru import gru_sequence as pallas_gru_sequence
from sheeprl_tpu.ops.seq_gru import gru_sequence_reference
from sheeprl_tpu_torch.ops.seq_gru import gru_sequence, gru_sequence_plain, sequence_grid

from test_torch_dreamer_v3_player import tiny_pair

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
R = 128  # the smallest H (and X) the sequence route takes
DECOUPLED = [
    "algo.world_model.decoupled_rssm=True",
    "algo.world_model.recurrent_model.fused_seq=True",
    f"algo.world_model.recurrent_model.recurrent_state_size={R}",
    f"algo.world_model.recurrent_model.dense_units={R}",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, steps, b, hidden=R, xdim=R):
    rng = np.random.default_rng(seed)
    is_first = np.zeros((steps, b, 1), np.float32)
    is_first[0] = 1.0
    is_first[steps // 2, b // 2] = 1.0
    is_first[steps - 1, 0] = 1.0
    args = [
        rng.normal(size=(b, hidden)),
        rng.normal(size=(steps, b, xdim)),
        rng.normal(scale=0.1, size=(hidden + xdim, 3 * hidden)),
        rng.normal(size=(3 * hidden,)),
        rng.normal(scale=0.1, size=(3 * hidden,)),
        is_first,
        rng.normal(size=(b, hidden)),
    ]
    return [a.astype(np.float32) for a in args]


@pytest.mark.parametrize("steps,b", [(8, 8), (5, 3)])
def test_plain_matches_reference_and_pallas(steps, b):
    args = _inputs(steps, steps, b)
    ref = gru_sequence_reference(*map(jnp.asarray, args))
    pallas = pallas_gru_sequence(*map(jnp.asarray, args), 1e-6, True)
    out = gru_sequence_plain(*map(torch.from_numpy, args))
    assert out.shape == (steps, b, R) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    # the op takes the plain version for CPU tensors, without a launch
    before = gru_sequence.launches
    np.testing.assert_array_equal(gru_sequence(*map(torch.from_numpy, args)).numpy(), out.numpy())
    assert gru_sequence.launches == before


@pytest.mark.parametrize("steps,b", [(7, 4), (6, 3)])
def test_backward_matches_pallas_custom_vjp(steps, b):
    args = _inputs(100 + steps, steps, b)
    probe = np.random.default_rng(9).normal(size=(steps, b, R)).astype(np.float32)
    is_first = jnp.asarray(args[5])

    def loss(h0, xs, w, gamma, beta, init_rec):
        return (pallas_gru_sequence(h0, xs, w, gamma, beta, is_first, init_rec, 1e-6, True) * probe).sum()

    diff = (0, 1, 2, 3, 4, 6)
    want = jax.grad(loss, argnums=tuple(range(6)))(*(jnp.asarray(args[i]) for i in diff))
    leaves = [torch.from_numpy(a).requires_grad_(i in diff) for i, a in enumerate(args)]
    out = gru_sequence(*leaves)
    got = torch.autograd.grad(out, [leaves[i] for i in diff], torch.from_numpy(probe))
    for name, a, ref in zip(("h0", "xs", "w", "gamma", "beta", "init_rec"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **GRAD_TOL, err_msg=name)
    # and against autograd through the plain loop
    plain = gru_sequence_plain(*leaves)
    got_plain = torch.autograd.grad(plain, [leaves[i] for i in diff], torch.from_numpy(probe))
    for name, a, ref in zip(("h0", "xs", "w", "gamma", "beta", "init_rec"), got, got_plain):
        np.testing.assert_allclose(a.numpy(), ref.numpy(), **GRAD_TOL, err_msg=name)


def test_sequence_grid_puts_a_block_on_each_sm():
    assert sequence_grid(512, 132) == (4, 128)  # DV3-S: 48 KB of W a block
    assert sequence_grid(128, 132) == (1, 128)
    assert sequence_grid(896, 132) == (7, 128)  # the largest H the 10 MB rule admits
    units, blocks = sequence_grid(1000, 132)
    assert (units - 1) * blocks < 1000 <= units * blocks


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(extra=DECOUPLED)


def test_recurrent_features_and_gated_step_match_flax(pair):
    rssm_j, p = pair["wm"].rssm, pair["params"]["world_model"]["rssm"]
    rssm = pair["agent"].world_model.rssm
    steps, b = 5, 3
    rng = np.random.default_rng(4)
    prev = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (steps, b, 4))]
    actions = rng.normal(size=(steps, b, 5)).astype(np.float32)
    is_first = (rng.uniform(size=(steps, b, 1)) < 0.3).astype(np.float32)
    init_post = rng.normal(size=(b, 16)).astype(np.float32)
    ref = rssm_j.apply(
        p, *map(jnp.asarray, (prev, actions, is_first, init_post)), method=jax_agent.RSSM.recurrent_features_seq
    )
    with torch.no_grad():
        feats = rssm.recurrent_features_seq(*map(torch.from_numpy, (prev, actions, is_first, init_post)))
    assert feats.shape == (steps, b, R)
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref), **TOL)

    h = np.tanh(rng.normal(size=(b, R))).astype(np.float32)
    init_rec = np.tanh(rng.normal(size=(b, R))).astype(np.float32)
    step_j = rssm_j.apply(
        p, jnp.asarray(ref[1]), jnp.asarray(h), jnp.asarray(is_first[1]), jnp.asarray(init_rec),
        method=jax_agent.RSSM.gru_step_gated,
    )
    with torch.no_grad():
        step = rssm.gru_step_gated(feats[1], *map(torch.from_numpy, (h, is_first[1], init_rec)))
    np.testing.assert_allclose(step.numpy(), np.asarray(step_j), **TOL)


def test_gru_sequence_gated_equals_a_loop_of_gated_steps(pair):
    rssm = pair["agent"].world_model.rssm
    assert not rssm.recurrent_model.gru.fused  # the cell's one-pass LayerNorm, as the sequence's
    steps, b = 6, 3
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.normal(size=(steps, b, R)).astype(np.float32))
    is_first = torch.zeros(steps, b, 1)
    is_first[0] = 1.0
    is_first[3, 1] = 1.0
    init_rec = torch.from_numpy(np.tanh(rng.normal(size=(b, R))).astype(np.float32))
    with torch.no_grad():
        hs = rssm.gru_sequence_gated(feats, is_first, init_rec)
        h, loop = torch.zeros(b, R), []
        for t in range(steps):
            h = rssm.gru_step_gated(feats[t], h, is_first[t], init_rec)
            loop.append(h)
    np.testing.assert_allclose(hs.numpy(), torch.stack(loop).numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "hidden,feat,eligible",
    [(512, 512, True), (4096, 1024, False), (160, 128, False), (128, 96, False), (896, 128, False), (768, 256, True)],
)
def test_seq_scan_eligible_agrees_with_jax(hidden, feat, eligible):
    """DV3-S (eligible), DV3-XL (its weight is 252 MB), sizes that are not
    multiples of 128, and both sides of the 10 MB limit."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import RSSM

    kw = dict(actions_dim=(3,), embedded_obs_dim=8, recurrent_state_size=hidden, dense_units=8, stochastic_size=2,
              discrete_size=2, hidden_size=8, decoupled=True, fused_seq=True)
    assert jax_agent.RSSM(**kw).seq_scan_eligible(feat) is eligible
    assert RSSM(**kw, device="meta").seq_scan_eligible(feat) is eligible
    assert not RSSM(**{**kw, "fused_seq": False}, device="meta").seq_scan_eligible(feat)
