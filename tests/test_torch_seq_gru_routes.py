"""The sequence LayerNorm-GRU's two routes on the card (``ops/seq_gru.py``),
on the CPU: which shapes each takes, and the cluster route's order of
operations emulated in torch against the JAX package.

- ``sequence_route`` at DV3-XS, DV3-S, H = 768 / X = 256 and large B,
  against budgets worked out by hand from ``csrc/seq_gru.cu``'s layout (the
  cluster route's shared memory a block: W[:H]'s 3U columns, hg in 16-row
  tiles, the 16 blocks' row sums, the block's 8-unit groups' row sums and
  the state's and the row sums' mbarriers;
  the grid route's: its 3S columns of the whole W, z and the statistics of
  every row, every block's partial sums and one staged row).
- :func:`emulate_cluster` follows the cluster route: the input product
  ``xs @ W[H:]`` for all steps first; then, per step, the product of the
  state with W[:H] in 3xTF32 (each operand split into its TF32 part and the
  rest as the kernel splits it: small_a big_b + big_a small_b + big_a
  big_b), 64 K rows at a time, summed over 4 K groups in order, plus zx[t];
  each row's sum and sum of squares over each of the 16 blocks' columns,
  summed in block order, for the one-pass LayerNorm; the gates; the reset
  gating of the next step's state.  It is held against
  ``gru_sequence_reference`` and the Pallas ``gru_sequence`` in interpret
  mode at 1e-5, the tolerance the JAX package holds its sequence kernel to.
  The kernel's exact summation order inside an MMA is the hardware's; the
  emulation fixes everything else the kernel's code orders.
- ``SEQ_F32_TOL`` (chip_smoke.py), the bound the card's check holds the
  sequence to against the plain loop in float64, passes an f32-accurate
  product and fails a ~16-bit one (split bf16, h1 (w1 + w2) + h2 w1), which
  ``SEQ_TOL`` (1e-4) cannot tell apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops.seq_gru import gru_sequence as pallas_gru_sequence
from sheeprl_tpu.ops.seq_gru import gru_sequence_reference
from sheeprl_tpu_torch.ops import seq_gru
from chip_smoke import SEQ_F32_TOL, gru_sequence_f64
from sheeprl_tpu_torch.ops.seq_gru import (
    CLUSTER_BLOCKS,
    MAX_UNITS,
    cluster_smem_bytes,
    grid_smem_bytes,
    gru_input_product,
    gru_sequence_plain,
    sequence_route,
)

TOL = dict(rtol=1e-5, atol=1e-5)
OPTIN = 232448  # an H100's shared memory a block may opt in to (227 KB)
SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, steps, b, hidden, xdim):
    rng = np.random.default_rng(seed)
    is_first = np.zeros((steps, b, 1), np.float32)
    is_first[0, 0] = 1.0
    is_first[steps // 2, b // 2] = 1.0
    is_first[steps - 1, 0] = 1.0
    args = [
        np.tanh(rng.normal(size=(b, hidden))),
        rng.normal(size=(steps, b, xdim)),
        rng.normal(scale=(hidden + xdim) ** -0.5, size=(hidden + xdim, 3 * hidden)),
        1 + 0.1 * rng.normal(size=(3 * hidden,)),
        0.1 * rng.normal(size=(3 * hidden,)),
        is_first,
        np.tanh(rng.normal(size=(b, hidden))),
    ]
    return [a.astype(np.float32) for a in args]


# ------------------------------------------------------------------ routing
def _cluster_bytes_by_hand(hidden, batch):
    units = hidden // 16
    rows = 16 * -(-batch // 16)
    w_slice = hidden * 3 * units  # W[:H]'s 3U columns
    state = rows * hidden  # hg, all H units, in 16-row tiles
    row_sums = 16 * rows * 2 + units // 8 * rows * 2
    return 4 * (w_slice + state + row_sums) + 16  # and two mbarriers


@pytest.mark.parametrize(
    "name,hidden,xdim,batch,route,cluster_bytes",
    [
        # DV3-XS: W[:H] is 768 KB, 48 KB a block
        ("DV3-XS", 256, 256, 16, "cluster", 4 * (256 * 48 + 16 * 256 + 512 + 2 * 32) + 16),
        # DV3-S, the decoupled cell: 192 KB of W and 32 KB of state, 496 bytes to spare
        ("DV3-S", 512, 512, 16, "cluster", 231952),
        ("DV3-S, one row", 512, 512, 1, "cluster", 231952),
        # a second 16-row tile no longer fits beside DV3-S's W slice
        ("DV3-S, B = 17", 512, 512, 17, "grid", 267280),
        # the scan takes it (W is 6 MB), but W[:H] is 6.75 MB: 432 KB a block
        ("H = 768, X = 256", 768, 256, 16, "grid", 494352),
        # B past two tiles: the grid route stages rows in chunks
        ("DV3-S, large B", 512, 512, 64, "grid", 0),
        ("DV3-XS, large B", 256, 256, 128, "grid", 0),
        ("H = 384, two tiles", 384, 128, 32, "cluster", 4 * (384 * 72 + 32 * 384 + 1024 + 3 * 64) + 16),
    ],
)
def test_sequence_route_against_hand_worked_budgets(name, hidden, xdim, batch, route, cluster_bytes):
    assert cluster_smem_bytes(hidden, batch) == cluster_bytes
    if cluster_bytes:
        assert cluster_bytes == _cluster_bytes_by_hand(hidden, batch)
    assert sequence_route(hidden, xdim, batch, OPTIN, SMS) == route, name


def test_grid_budget_by_hand():
    """H = 768, X = 256, B = 16 on 132 SMs: 6 units a block (128 blocks);
    3 x 6 columns of the 1,024 rows of W, z (16 x 18), the row statistics
    (16 x 2), 128 blocks' partial sums (128 x 16 x 2) and one staged row."""
    assert seq_gru.sequence_grid(768, SMS) == (6, 128)
    assert grid_smem_bytes(768, 256, 16, SMS) == 4 * (18 * 1024 + 16 * 18 + 32 + 128 * 16 * 2 + 1024) == 95488


def test_sequence_route_refuses_what_neither_route_takes():
    with pytest.raises(ValueError, match="units"):
        sequence_route(9 * SMS, 8, 2, OPTIN, SMS)  # 9 units a block on the grid; not a multiple of 128
    with pytest.raises(ValueError, match="does not fit"):
        sequence_route(1024, 8192, 16, OPTIN, SMS)  # the grid's W columns alone exceed a block
    with pytest.raises(ValueError, match="does not fit"):
        sequence_route(256, 256, 512, OPTIN, SMS)  # 128 blocks' partial sums of 512 rows: 512 KB
    assert cluster_smem_bytes(200, 2) == cluster_smem_bytes(512, 33) == 0
    assert sequence_route(128, 128, 3, OPTIN, SMS) == "cluster"
    assert sequence_route(128, 128, 3, 20000, SMS) == "grid"  # a card with less shared memory
    assert MAX_UNITS == 8 and CLUSTER_BLOCKS == 16


def test_smem_formula_matches_the_source():
    """``cluster_smem_bytes`` counts what ``csrc/seq_gru.cu:cluster_floats``
    lays out (read from the source, as the card's library reports it)."""
    src = seq_gru.LIBRARY.source.read_text()
    assert "return 3 * H * H / 16 + MT * 16 * H + kCluster * MT * 16 * 2 + (H / kCluster / 8) * MT * 16 * 2 + 4;" in src
    assert "constexpr int kCluster = 16;" in src
    for hidden, batch in ((128, 1), (256, 16), (384, 32), (512, 16)):
        mt = -(-batch // 16)
        floats = 3 * hidden * hidden // 16 + mt * 16 * hidden + 16 * mt * 16 * 2 + hidden // 16 // 8 * mt * 16 * 2 + 4
        assert cluster_smem_bytes(hidden, batch) == 4 * floats


# ---------------------------------------------------------------- emulation
def _tf32(v):
    """v cut to TF32 (the upper 19 bits), as the tensor cores read it."""
    return (v.view(torch.int32) & -8192).view(torch.float32)


def _tf32x3(h, w):
    """h @ w as the cluster route's 3xTF32: big = the operand cut to TF32,
    small = the rest (cut again when the tensor cores read it)."""
    hb, wb = _tf32(h), _tf32(w)
    hs, ws = _tf32(h - hb), _tf32(w - wb)
    return (hs @ wb + hb @ ws) + hb @ wb


def _bf16(v):
    return v.to(torch.bfloat16).float()


def _bf16x2(h, w):
    """h @ w from bf16 parts, h1 (w1 + w2) + h2 w1 (v1 = bf16(v), v2 =
    bf16(v - v1)): about 16-17 bits of the product."""
    h1, w1 = _bf16(h), _bf16(w)
    h2, w2 = _bf16(h - h1), _bf16(w - w1)
    return h1 @ (w1 + w2) + h2 @ w1


def _blend(h, init, f):
    return (1.0 - f) * h + f * init


def emulate_cluster(h0, xs, w, gamma, beta, is_first, init_rec, eps=1e-6, k_groups=4, product=_tf32x3):
    steps, b, xdim = xs.shape
    hidden = h0.shape[1]
    units = hidden // CLUSTER_BLOCKS
    n = 3 * hidden
    zx = gru_input_product(xs.reshape(steps * b, xdim), w[hidden:]).reshape(steps, b, n)  # before the loop
    wh = w[:hidden]
    rows_k = hidden // k_groups
    # the columns of block r: gates 0, 1, 2 of its units [r U, (r + 1) U)
    cols = [torch.cat([g * hidden + torch.arange(r * units, (r + 1) * units) for g in range(3)])
            for r in range(CLUSTER_BLOCKS)]
    hg = _blend(h0, init_rec, is_first[0])
    out = []
    for t in range(steps):
        z = None
        for kg in range(k_groups):  # the K groups' sums, added in group order
            acc = None
            for k0 in range(kg * rows_k, (kg + 1) * rows_k, 64):  # 64 K rows apart, then added
                ks = slice(k0, min(k0 + 64, (kg + 1) * rows_k))
                part = product(hg[:, ks], wh[ks])
                acc = part if acc is None else acc + part
            z = acc if z is None else z + acc
        z = z + zx[t]
        s = torch.zeros(b)
        q = torch.zeros(b)
        for c in cols:  # every block's row sums, in block order
            s = s + z[:, c].sum(-1)
            q = q + (z[:, c] * z[:, c]).sum(-1)
        mu = (s / n)[:, None]
        rstd = torch.rsqrt(torch.clamp(q[:, None] / n - mu * mu, min=0.0) + eps)
        parts = (z - mu) * rstd * gamma + beta
        reset = torch.sigmoid(parts[:, :hidden])
        cand = torch.tanh(reset * parts[:, hidden : 2 * hidden])
        update = torch.sigmoid(parts[:, 2 * hidden :] - 1.0)
        h = update * cand + (1.0 - update) * hg
        out.append(h)
        if t + 1 < steps:
            hg = _blend(h, init_rec, is_first[t + 1])
    return torch.stack(out)


@pytest.mark.parametrize("steps,b,hidden,xdim", [(8, 8, 128, 128), (5, 3, 128, 256), (4, 16, 256, 128)])
def test_emulated_cluster_route_matches_reference_and_pallas(steps, b, hidden, xdim):
    args = _inputs(steps + b, steps, b, hidden, xdim)
    got = emulate_cluster(*map(torch.from_numpy, args))
    ref = gru_sequence_reference(*map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    pallas = pallas_gru_sequence(*map(jnp.asarray, args), 1e-6, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), gru_sequence_plain(*map(torch.from_numpy, args)).numpy(), **TOL)


def test_tf32_parts_keep_the_product_to_f32_accuracy():
    """3xTF32 against the f64 product, on rows of 512 terms: within 2^-22 of
    the sum of the terms' magnitudes, as the f32 product is (each operand
    kept to 2^-20, the dropped small x small piece 2^-22 of a term, the
    terms' errors of both signs); the bf16 parts' product is not within
    2^-21 (it drops 2^-16 and 2^-17 of each term)."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(16, 512)).astype(np.float32))
    w = torch.from_numpy(rng.normal(scale=512**-0.5, size=(512, 96)).astype(np.float32))
    exact = h.double() @ w.double()
    scale = h.double().abs() @ w.double().abs()
    hb, wb = _tf32(h), _tf32(w)
    hs, ws = _tf32(h - hb), _tf32(w - wb)
    got = hs.double() @ wb.double() + hb.double() @ ws.double() + hb.double() @ wb.double()
    assert float(((got - exact).abs() / scale).max()) < 2**-22
    assert float(((h @ w - exact).abs() / scale).max()) < 2**-22
    assert float(((hb + hs - h).abs() / h.abs()).max()) <= 2**-20
    h1, w1 = _bf16(h), _bf16(w)
    h2, w2 = _bf16(h - h1), _bf16(w - w1)
    split = h1.double() @ (w1.double() + w2.double()) + h2.double() @ w1.double()
    assert float(((split - exact).abs() / scale).max()) > 2**-21


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f32_tolerance_tells_a_16_bit_product_from_f32(seed):
    """At the decoupled DV3-S shape (T = 64, B = 16, H = X = 512), against the
    plain loop in float64: the emulated cluster route in 3xTF32 and the f32
    plain loop stay within SEQ_F32_TOL, the same route with a split-bf16
    product does not, and both are far inside SEQ_TOL (1e-4)."""
    args = [torch.from_numpy(a) for a in _inputs(seed, 64, 16, 512, 512)]
    exact = gru_sequence_f64(torch, *args)
    f32 = float((gru_sequence_plain(*args).double() - exact).abs().max())
    tf32x3 = float((emulate_cluster(*args).double() - exact).abs().max())
    bf16x2 = float((emulate_cluster(*args, product=_bf16x2).double() - exact).abs().max())
    assert max(f32, tf32x3) <= SEQ_F32_TOL < bf16x2 <= 1e-4, (f32, tf32x3, bf16x2)


def test_input_product_on_the_cpu_is_the_f32_product():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(12, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 24)).astype(np.float32))
    before = gru_input_product.launches
    torch.testing.assert_close(gru_input_product(x, w), x @ w, rtol=0, atol=0)
    assert gru_input_product.launches == before
