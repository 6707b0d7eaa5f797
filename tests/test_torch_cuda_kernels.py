"""The port's hand-written CUDA kernels against their plain versions.

These tests need a CUDA device (a kernel has no CPU mode) and skip without
one.  They import only torch and the port, so they run where JAX is not
installed; on a machine with a card run them without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from sheeprl_tpu_torch.ops.gru_cell import gru_cell, gru_cell_plain


GRU_SHAPES = [
    (1, 4096, 1024), (7, 4096, 1024), (64, 4096, 1024), (3, 40, 24),
    (1024, 4096, 1024), (1024, 512, 512), (100, 4096, 1024), (129, 512, 512),
]


def _gru_inputs(batch, hidden, xdim, wdtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(batch, hidden, device="cuda", generator=g)
    x = torch.randn(batch, xdim, device="cuda", generator=g)
    w = (torch.randn(hidden + xdim, 3 * hidden, device="cuda", generator=g) * (hidden + xdim) ** -0.5).to(getattr(torch, wdtype))
    gamma = 1 + 0.1 * torch.randn(3 * hidden, device="cuda", generator=g)
    beta = 0.1 * torch.randn(3 * hidden, device="cuda", generator=g)
    return h, x, w, gamma, beta


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden,xdim", GRU_SHAPES)
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(batch, hidden, xdim, wdtype):
    """The CUDA kernel against its plain version on the card: at the XL
    widths the serving path gives it (H=4096, X=1024, B = 1, 7, 64), at
    imagination's B = 1024 at XL and DV3-S (H = X = 512) widths, at batches
    that leave part of a 128- or 64-row tile empty (100, 129), and at a
    width (3, 40, 24) where N = 120 leaves part of a 128-column tile empty
    and K = 64 has a ragged h and x segment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    h, x, w, gamma, beta = _gru_inputs(batch, hidden, xdim, wdtype, batch)
    tol = 2e-5 if wdtype == "float32" else 2e-3
    for two_pass in (True, False):
        out = gru_cell(h, x, w, gamma, beta, two_pass=two_pass)
        ref = gru_cell_plain(h, x, w, gamma, beta, two_pass=two_pass)
        torch.cuda.synchronize()
        assert (out - ref).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden,xdim", [(64, 4096, 1024), (1024, 512, 512), (3, 40, 24)])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_cuda_kernel_rounds_parts_like_plain(batch, hidden, xdim, xdtype):
    """``round_parts`` (the unfused cell under bf16) on the card: bf16 W,
    the product rounded to bf16 before the fast-variance LayerNorm, within
    the bf16 tolerance (2e-3) of the plain version.  The inputs lie on a
    grid (multiples of 1/8 for h and x, 1/64 for W, |values| <= 1) where
    every partial sum of the product is exact in f32, so both sides round
    the same sums; on random inputs a sum that the two summation orders
    put on either side of a rounding boundary moves its output by a bf16
    ulp of its normalised part, more than the tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(batch)
    h = torch.randint(-8, 9, (batch, hidden), device="cuda", generator=g).float() / 8
    x = (torch.randint(-8, 9, (batch, xdim), device="cuda", generator=g).float() / 8).to(getattr(torch, xdtype))
    w = (torch.randint(-64, 65, (hidden + xdim, 3 * hidden), device="cuda", generator=g).float() / 64).to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn(3 * hidden, device="cuda", generator=g)
    beta = 0.1 * torch.randn(3 * hidden, device="cuda", generator=g)
    out = gru_cell(h, x, w, gamma, beta, two_pass=False, round_parts=True)
    ref = gru_cell_plain(h, x, w, gamma, beta, two_pass=False, round_parts=True)
    unrounded = gru_cell_plain(h, x, w, gamma, beta, two_pass=False)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    assert err <= 2e-3
    assert err < 0.1 * (unrounded - ref).abs().max().item()  # far closer to the rounded step than the rounding moves it


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden,xdim,wdtype", [(1024, 4096, 1024, "float32"), (16, 4096, 1024, "float32"), (64, 4096, 1024, "bfloat16"), (129, 512, 512, "float32")])
def test_cuda_kernel_is_deterministic(batch, hidden, xdim, wdtype):
    """Two calls on the same inputs give the same bytes: no atomics, the
    K slices summed in a fixed order (B = 16 and 64 split K, B = 1024 at XL
    does not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _gru_inputs(batch, hidden, xdim, wdtype, 7)
    first = gru_cell(*args)
    second = gru_cell(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_kernel_raises_on_what_it_does_not_take():
    """Rows that 16-byte copies cannot stage raise before any launch: X not
    a multiple of 4, and H or X not a multiple of 8 for bf16 operands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    before = gru_cell.launches
    for hidden, xdim, wdtype, xdtype in ((8, 6, "float32", "float32"), (12, 8, "bfloat16", "float32"), (8, 12, "bfloat16", "bfloat16")):
        h, x, w, gamma, beta = _gru_inputs(2, hidden, xdim, wdtype, 0)
        with pytest.raises(ValueError):
            gru_cell(h, x.to(getattr(torch, xdtype)), w, gamma, beta)
    assert gru_cell.launches == before


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


def _tree(n_leaves, priorities):
    """A ``PriorityTree`` on the card holding ``priorities``."""
    from sheeprl_tpu_torch.replay.priority_tree import PriorityTree

    tree = PriorityTree(n_leaves, device="cuda")
    tree.load_state_dict({"leaves": priorities.cpu().numpy(), "max_priority": 1.0})
    return tree


@pytest.mark.cuda
@pytest.mark.parametrize("n_leaves", [8, 1000, 1 << 16])
@pytest.mark.parametrize("n_excl", [0, 4, 63])
def test_sum_tree_sample_matches_plain(n_leaves, n_excl):
    """Draws with 0, 4 and 63 exclusions on integer-valued priorities (exact
    sums): leaves identical to the plain version, weights to 1e-6 relative;
    1000 leaves pad to 1024, and no padded or excluded leaf is drawn."""
    from sheeprl_tpu_torch.ops.per import sum_tree_sample, sum_tree_sample_plain

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(n_leaves + n_excl)
    tree = _tree(n_leaves, torch.randint(0, 9, (n_leaves,), generator=g, device="cuda").float())
    n_excl = min(n_excl, n_leaves - 2)
    excl = torch.randperm(n_leaves, generator=g, device="cuda")[:n_excl].to(torch.int32) if n_excl else None
    r01 = torch.rand(4096, generator=g, device="cuda")
    before = sum_tree_sample.launches
    leaf, w = sum_tree_sample(tree.tree, r01, 0.6, n_leaves, depth=tree.depth, exclude_idx=excl)
    leaf_p, w_p = sum_tree_sample_plain(tree.tree, r01, 0.6, n_leaves, depth=tree.depth, exclude_idx=excl)
    torch.cuda.synchronize()
    assert sum_tree_sample.launches == before + 1
    assert torch.equal(leaf, leaf_p) and int(leaf.max()) < n_leaves
    assert ((w - w_p).abs() <= 1e-6 * w_p.abs()).all()
    if excl is not None:
        assert not torch.isin(leaf, excl).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_leaves", [6, 1000, 1 << 20])
def test_sum_tree_write_and_update_match_plain(n_leaves):
    """Writes with equal duplicates, unequal active duplicates (the last
    active lane wins) and inactive lanes, then an update with its running
    max: tree slots 1.. bit-equal to the plain version.  The owner scratch
    is shared by both calls and comes back all -1."""
    from sheeprl_tpu_torch.ops.per import (
        owner_scratch,
        sum_tree_update,
        sum_tree_update_plain,
        sum_tree_write,
        sum_tree_write_plain,
    )

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(n_leaves)
    tree = _tree(n_leaves, torch.rand(n_leaves, generator=g, device="cuda"))
    lanes = 4096
    leaf = torch.randint(0, n_leaves, (lanes,), generator=g, device="cuda", dtype=torch.int32)
    leaf[2048:2560] = leaf[:512]
    vals = torch.rand(lanes, generator=g, device="cuda")
    vals[2048:2304] = vals[:256]
    active = torch.rand(lanes, generator=g, device="cuda") < 0.7
    a, b = tree.tree.clone(), tree.tree.clone()
    owner = owner_scratch(tree.depth, "cuda")
    before = (sum_tree_write.launches, sum_tree_update.launches)
    sum_tree_write(a, leaf, vals, active, depth=tree.depth, owner=owner)
    sum_tree_write_plain(b, leaf, vals, active, depth=tree.depth)
    ma = sum_tree_update(a, torch.tensor(0.5, device="cuda"), leaf, vals * 2, active, depth=tree.depth, owner=owner)
    mb = sum_tree_update_plain(b, torch.tensor(0.5, device="cuda"), leaf, vals * 2, active, depth=tree.depth)
    torch.cuda.synchronize()
    assert (sum_tree_write.launches, sum_tree_update.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(a[1:], b[1:]) and float(ma) == float(mb)
    assert float(a[0]) == float(tree.tree[0])  # slot 0 is never written
    assert bool((owner == -1).all())


@pytest.mark.cuda
def test_priority_tree_kernel_writes_keep_one_clean_scratch():
    """``PriorityTree`` with the kernels: seeding, updates with unequal
    duplicates and a decay, all through one scratch that stays -1 between
    calls, each tree equal to the plain tree's."""
    from sheeprl_tpu_torch.replay.priority_tree import PriorityTree

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(11)
    fast, plain = PriorityTree(1000, device="cuda", kernel="pallas"), PriorityTree(1000, device="cuda", kernel="lax")
    for step in range(4):
        leaf = torch.randint(0, 1000, (512,), generator=g, device="cuda")
        td = torch.rand(512, generator=g, device="cuda")
        for t in (fast, plain):
            t.seed_max(leaf[:64], None)
            t.update(leaf, td)
            t.scale(leaf[:32], 0.5)
        scratch = fast._owner
        assert scratch is not None and bool((scratch == -1).all())
        assert torch.equal(fast.tree[1:], plain.tree[1:]) and float(fast.max_priority) == float(plain.max_priority)
    assert fast._owner is scratch  # made once


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,feat", [("uint8", ()), ("uint8", (1,)), ("uint8", (24,)), ("float32", (1,)), ("float32", (6,)), ("float32", (24,))])
@pytest.mark.parametrize("next_obs", [False, True])
def test_gather_transitions_bytes_exact(dtype, feat, next_obs):
    """The transition gather against per-key advanced indexing, bytes exact:
    rows of 1, 24 and 96 bytes beside a 1-byte flag key, successor rows
    that wrap the ring, every key (and its successor) in one launch."""
    from sheeprl_tpu_torch.ops.gather import gather_transitions, gather_transitions_plain

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(len(feat))
    cap, n_envs, flat = 97, 4, 1000
    shape = (cap, n_envs, *feat)
    if dtype == "uint8":
        ring = torch.randint(0, 256, shape, generator=g, device="cuda", dtype=torch.uint8)
    else:
        ring = torch.randn(shape, generator=g, device="cuda")
    bufs = {"x": ring, "flag": torch.randint(0, 2, (cap, n_envs, 1), generator=g, device="cuda", dtype=torch.uint8)}
    rows = torch.randint(0, cap, (flat,), generator=g, device="cuda", dtype=torch.int32)
    rows[:5] = cap - 1
    envs = torch.randint(0, n_envs, (flat,), generator=g, device="cuda", dtype=torch.int32)
    next_keys = ("x", "flag") if next_obs else ()
    before = gather_transitions.launches
    out = gather_transitions(bufs, rows, envs, next_keys=next_keys)
    ref = gather_transitions_plain(bufs, rows, envs, next_keys=next_keys)
    torch.cuda.synchronize()
    assert gather_transitions.launches == before + 1
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype and torch.equal(out[k], ref[k]), k


def _sequence_inputs(g, steps, batch, hidden, xdim):
    is_first = torch.zeros(steps, batch, 1, device="cuda")
    is_first[0, 0] = 1.0  # the other rows start from h0, so dh0 is not all zero
    is_first[steps // 2, batch // 2] = 1.0
    return [
        torch.tanh(torch.randn(batch, hidden, device="cuda", generator=g)),
        torch.randn(steps, batch, xdim, device="cuda", generator=g),
        torch.randn(hidden + xdim, 3 * hidden, device="cuda", generator=g) * (hidden + xdim) ** -0.5,
        1 + 0.1 * torch.randn(3 * hidden, device="cuda", generator=g),
        0.1 * torch.randn(3 * hidden, device="cuda", generator=g),
        is_first,
        torch.tanh(torch.randn(batch, hidden, device="cuda", generator=g)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "steps,batch,hidden,xdim", [(64, 16, 512, 512), (5, 3, 128, 128), (9, 33, 256, 128), (3, 2, 200, 72), (4, 16, 128, 8192)]
)
def test_gru_sequence_matches_plain(steps, batch, hidden, xdim):
    """The sequence op against its plain loop, resets mid-sequence: the
    decoupled DV3-S cell's shape and the smallest eligible width at an odd
    batch (the cluster route), a batch past two 16-row tiles and H that
    does not split evenly over the blocks (the grid route), and X = 8192
    (the cluster route's input product over a long K); one recurrence
    launch each, and the same bits twice."""
    from sheeprl_tpu_torch.ops.seq_gru import gru_sequence, gru_sequence_plain

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _sequence_inputs(torch.Generator(device="cuda").manual_seed(steps), steps, batch, hidden, xdim)
    before = gru_sequence.launches
    out = gru_sequence(*args)
    again = gru_sequence(*args)
    ref = gru_sequence_plain(*args)
    torch.cuda.synchronize()
    assert gru_sequence.launches == before + 2
    assert out.shape == (steps, batch, hidden) and torch.equal(out, again)
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_gru_sequence_backward_matches_plain_autograd():
    """The op's gradients (kernel forward, efficient-BPTT backward) against
    autograd through the plain loop at the DV3-S cell's shape: within 1e-3
    of each gradient's largest magnitude."""
    from sheeprl_tpu_torch.ops.seq_gru import gru_sequence, gru_sequence_plain

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _sequence_inputs(torch.Generator(device="cuda").manual_seed(1), 64, 16, 512, 512)
    diff = (0, 1, 2, 3, 4, 6)
    leaves = [a.requires_grad_(i in diff) for i, a in enumerate(args)]
    wanted = [leaves[i] for i in diff]
    up = torch.randn(64, 16, 512, device="cuda")
    got = torch.autograd.grad(gru_sequence(*leaves), wanted, up)
    ref = torch.autograd.grad(gru_sequence_plain(*leaves), wanted, up)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item()


@pytest.mark.cuda
def test_gru_sequence_raises_on_what_the_kernel_does_not_take():
    """bf16 operands raise on the card (no fallback to the plain version),
    and so does an H the grid cannot hold."""
    from sheeprl_tpu_torch.ops.seq_gru import gru_sequence

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _sequence_inputs(torch.Generator(device="cuda").manual_seed(2), 4, 2, 128, 128)
    before = gru_sequence.launches
    with pytest.raises(TypeError, match="float32"):
        gru_sequence(*args[:2], args[2].to(torch.bfloat16), *args[3:])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    big = _sequence_inputs(torch.Generator(device="cuda").manual_seed(3), 2, 2, 9 * sms, 8)
    with pytest.raises(ValueError, match="units"):
        gru_sequence(*big)
    assert gru_sequence.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n_excl", [1024, 1025, 2016])
def test_sum_tree_sample_streams_exclusions(n_excl):
    """Around the shared-memory chunk of 1024 exclusions and at 63 x 32
    (DV3's prioritized starts on 32 envs), on integer-valued priorities
    (exact sums): leaves identical to the plain version."""
    from sheeprl_tpu_torch.ops.per import sum_tree_sample, sum_tree_sample_plain

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(n_excl)
    n_leaves = 1 << 16
    tree = _tree(n_leaves, torch.randint(0, 9, (n_leaves,), generator=g, device="cuda").float())
    excl = torch.randperm(n_leaves, generator=g, device="cuda")[:n_excl].to(torch.int32)
    active = torch.rand(n_excl, generator=g, device="cuda") < 0.9
    r01 = torch.rand(16384, generator=g, device="cuda")
    leaf, w = sum_tree_sample(tree.tree, r01, 0.6, n_leaves, depth=tree.depth, exclude_idx=excl, exclude_active=active)
    leaf_p, w_p = sum_tree_sample_plain(
        tree.tree, r01, 0.6, n_leaves, depth=tree.depth, exclude_idx=excl, exclude_active=active
    )
    torch.cuda.synchronize()
    assert torch.equal(leaf, leaf_p)
    assert ((w - w_p).abs() <= 1e-6 * w_p.abs()).all()
    assert not torch.isin(leaf, excl[active]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_excl", [0, 1, 63, 2016])
def test_sum_tree_descend_matches_plain(n_excl):
    """Kernel #8 on one shard's sub-tree at the sharded SAC path's size
    (250,000 leaves, depth 18), 16,384 draws in the shard's mass interval,
    integer-valued priorities (exact sums): leaves and masses identical to
    the plain version, no excluded or padded leaf reached."""
    from sheeprl_tpu_torch.ops.per import sum_tree_descend, sum_tree_descend_plain

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(100 + n_excl)
    n_leaves = 250000
    tree = _tree(n_leaves, torch.randint(0, 9, (n_leaves,), generator=g, device="cuda").float())
    excl = torch.randperm(n_leaves, generator=g, device="cuda")[:n_excl].to(torch.int32) if n_excl else None
    p = 1 << tree.depth
    m = tree.tree[1] - (tree.tree[excl.long() + p].sum() if n_excl else 0.0)
    u = torch.rand(16384, generator=g, device="cuda") * m * (1.0 - 1e-7)
    before = sum_tree_descend.launches
    leaf, mass = sum_tree_descend(tree.tree, u, depth=tree.depth, exclude_idx=excl)
    leaf_p, mass_p = sum_tree_descend_plain(tree.tree, u, depth=tree.depth, exclude_idx=excl)
    torch.cuda.synchronize()
    assert sum_tree_descend.launches == before + 1
    assert leaf.dtype == torch.int32 and torch.equal(leaf, leaf_p) and torch.equal(mass, mass_p)
    assert int(leaf.max()) < n_leaves
    if excl is not None:
        assert not torch.isin(leaf, excl).any()


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [256, 16384])
def test_sum_tree_scatter_matches_plain(lanes):
    """Kernel #9 for each of 4 shards on its sub-tree (250,000 leaves):
    duplicate lanes with equal and unequal values, inactive lanes and the
    other shards' lanes on the same local leaves; heaps identical from slot
    1, the candidate max exact, slot 0 untouched, the owner scratch clean."""
    from sheeprl_tpu_torch.ops.per import owner_scratch, sum_tree_scatter, sum_tree_scatter_plain

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(lanes)
    n_leaves = 250000
    tree = _tree(n_leaves, torch.rand(n_leaves, generator=g, device="cuda"))
    leaf = torch.randint(0, n_leaves, (lanes,), generator=g, device="cuda", dtype=torch.int32)
    leaf[lanes // 2 :] = leaf[: lanes - lanes // 2]
    vals = torch.rand(lanes, generator=g, device="cuda") * 3
    vals[lanes // 2 : lanes // 2 + lanes // 4] = vals[: lanes // 4]
    active = torch.rand(lanes, generator=g, device="cuda") < 0.7
    shard_ids = torch.randint(0, 4, (lanes,), generator=g, device="cuda", dtype=torch.int32)
    owner = owner_scratch(tree.depth, "cuda")
    for rank in range(4):
        a, b = tree.tree.clone(), tree.tree.clone()
        before = sum_tree_scatter.launches
        out, cand = sum_tree_scatter(a, leaf, vals, active, shard_ids, rank, depth=tree.depth, owner=owner)
        _, cand_p = sum_tree_scatter_plain(b, leaf, vals, active, shard_ids, rank, depth=tree.depth)
        torch.cuda.synchronize()
        assert out is a and sum_tree_scatter.launches == before + 1
        assert torch.equal(a[1:], b[1:]) and float(cand) == float(cand_p)
        assert float(a[0]) == float(tree.tree[0])
        assert bool((owner == -1).all())


@pytest.mark.cuda
def test_sharded_priority_tree_kernels_match_lax():
    """``ShardedPriorityTree`` on 4 shards with kernels #8 and #9 against the
    same tree through the plain functions: seeding, TD updates, a decay and
    a draw, the trees and the draws identical; the four shards share one
    owner scratch."""
    from sheeprl_tpu_torch.replay.priority_tree import ShardedPriorityTree, shard_proportional_draw

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(21)
    fast = ShardedPriorityTree(1000, 8, 4, "cuda", kernel="pallas")
    plain = ShardedPriorityTree(1000, 8, 4, "cuda", kernel="lax")
    for _ in range(3):
        leaf = torch.randint(0, 8000, (2048,), generator=g, device="cuda")
        td = torch.randint(0, 20, (2048,), generator=g, device="cuda").float()
        for t in (fast, plain):
            t.seed_max(leaf[:256], None)
            t.update(leaf, td)
            t.scale(leaf[:64], 0.5)
        assert torch.equal(fast.trees[:, 1:], plain.trees[:, 1:]) and float(fast.max_priority) == float(plain.max_priority)
    # one scratch serves the four shards' scatters and comes back clean
    assert fast._owner.shape == (1 << fast.depth,) and bool((fast._owner == -1).all())
    r01 = torch.rand(4096, generator=g, device="cuda")
    got = shard_proportional_draw(list(fast.trees), r01, depth=fast.depth, kernel="pallas")
    want = shard_proportional_draw(list(plain.trees), r01, depth=plain.depth, kernel="lax")
    for a, b in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _packed_exclusions(n_leaves, n_excl, start):
    """``n_excl`` adjacent leaves from ``start``: as few buckets (subtrees
    under a draw's shared-memory levels) as hold them, one where they fit."""
    return (torch.arange(n_excl, device="cuda", dtype=torch.int32) + start) % n_leaves


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [8, 14, 20])
@pytest.mark.parametrize("n", [1, 1000])
@pytest.mark.parametrize("n_excl", [0, 1, 4, 63, 252, 1025, 2016])
def test_draws_match_plain(depth, n, n_excl):
    """Kernels #5 and #8 at a depth under the 10 shared-memory levels, at 14
    and at 20, for 1 draw and for 1000 (not a multiple of the block), with
    0 to 2016 adjacent exclusions (one bucket where they fit), integer
    priorities: leaves (and masses) identical to the plain versions, weights
    to 1e-6 relative.  One scratch serves every call, and what it holds on
    entry does not matter: it is filled with junk before each."""
    from sheeprl_tpu_torch.ops import per

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(depth * 10000 + n_excl + n)
    n_leaves = 1 << depth
    n_excl = min(n_excl, n_leaves // 2)
    tree = _tree(n_leaves, torch.randint(0, 9, (n_leaves,), generator=g, device="cuda").float())
    excl = _packed_exclusions(n_leaves, n_excl, n_leaves // 3) if n_excl else None
    p = 1 << tree.depth
    m = tree.tree[1] - (tree.tree[excl.long() + p].sum() if n_excl else 0.0)
    r01 = torch.rand(n, generator=g, device="cuda")
    u = r01 * m * (1.0 - 1e-7)
    scratch = per.draw_scratch(tree.depth, n_excl, "cuda")
    leaf_p, w_p = per.sum_tree_sample_plain(tree.tree, r01, 0.6, n_leaves, depth=tree.depth, exclude_idx=excl)
    dleaf_p, mass_p = per.sum_tree_descend_plain(tree.tree, u, depth=tree.depth, exclude_idx=excl)
    for junk in (0, -1, 0x7F7FFFFF):
        scratch.fill_(junk)
        leaf, w = per.sum_tree_sample(tree.tree, r01, 0.6, n_leaves, depth=tree.depth, exclude_idx=excl, scratch=scratch)
        scratch.fill_(junk)
        dleaf, mass = per.sum_tree_descend(tree.tree, u, depth=tree.depth, exclude_idx=excl, scratch=scratch)
        torch.cuda.synchronize()
        assert torch.equal(leaf, leaf_p) and ((w - w_p).abs() <= 1e-6 * w_p.abs()).all()
        assert torch.equal(dleaf, dleaf_p) and torch.equal(mass, mass_p)
    if excl is not None:
        assert not torch.isin(leaf, excl).any() and not torch.isin(dleaf, excl).any()


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [6, 18])
def test_draws_on_a_tree_with_one_nonzero_leaf(depth):
    """Every draw lands on the one leaf with mass, with and without
    exclusions of other leaves; its weight is 1."""
    from sheeprl_tpu_torch.ops import per

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    n_leaves = 1 << depth
    pri = torch.zeros(n_leaves, device="cuda")
    pri[n_leaves // 2 + 3] = 5.0
    tree = _tree(n_leaves, pri)
    r01 = torch.rand(777, generator=torch.Generator(device="cuda").manual_seed(depth), device="cuda")
    for excl in (None, torch.tensor([0, 1, n_leaves - 1], device="cuda", dtype=torch.int32),
                 torch.arange(min(100, n_leaves // 2), device="cuda", dtype=torch.int32)):
        leaf, w = per.sum_tree_sample(tree.tree, r01, 0.4, n_leaves, depth=tree.depth, exclude_idx=excl)
        dleaf, mass = per.sum_tree_descend(tree.tree, r01 * 5.0, depth=tree.depth, exclude_idx=excl)
        torch.cuda.synchronize()
        assert bool((leaf == n_leaves // 2 + 3).all()) and bool((w == 1.0).all())
        assert bool((dleaf == n_leaves // 2 + 3).all()) and bool((mass == 5.0).all())


@pytest.mark.cuda
def test_priority_tree_draws_keep_one_scratch():
    """``PriorityTree.sample`` with the kernels keeps one draw scratch and
    makes a larger one only for more exclusions than it has room for; the
    draws equal the lax tree's."""
    from sheeprl_tpu_torch.ops import per
    from sheeprl_tpu_torch.replay.priority_tree import PriorityTree

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(5)
    fast, plain = PriorityTree(5000, device="cuda", kernel="pallas"), PriorityTree(5000, device="cuda", kernel="lax")
    pri = torch.randint(1, 9, (5000,), generator=g, device="cuda").float()
    for t in (fast, plain):
        t.set_priorities(torch.arange(5000, device="cuda"), pri)
    kept = []
    for n_excl in (0, 4, 0, 300, 16):
        excl = torch.randperm(5000, generator=g, device="cuda")[:n_excl] if n_excl else None
        r01 = torch.rand(4096, generator=g, device="cuda")
        got = fast.sample(4096, beta=0.4, count=5000, exclude_idx=excl, r01=r01)
        want = plain.sample(4096, beta=0.4, count=5000, exclude_idx=excl, r01=r01)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and ((got[1] - want[1]).abs() <= 1e-6 * want[1].abs()).all()
        kept.append(fast._draws)
    assert kept[1] is kept[2] and kept[3] is kept[4] and kept[0] is not kept[1] and kept[2] is not kept[3]
    assert fast._draws.numel() == per.draw_scratch(fast.depth, 300, "cuda").numel()
    with pytest.raises(ValueError, match="needed"):
        per.sum_tree_sample(fast.tree, r01, 0.4, 5000, depth=fast.depth, exclude_idx=excl, scratch=kept[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n_excl", [0, 4, 100])
def test_sample_of_more_draws_than_resident_threads(n_excl):
    """300,000 draws are more than the cooperative sample's resident blocks
    hold a thread each (at most 1,024 blocks of 256): its threads loop over
    several draws each.  Leaves identical to the plain version, weights to
    1e-6 relative, twice on one scratch."""
    from sheeprl_tpu_torch.ops import per

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(300 + n_excl)
    n_leaves = 1 << 14
    tree = _tree(n_leaves, torch.randint(0, 9, (n_leaves,), generator=g, device="cuda").float())
    excl = torch.randperm(n_leaves, generator=g, device="cuda")[:n_excl].to(torch.int32) if n_excl else None
    r01 = torch.rand(300000, generator=g, device="cuda")
    scratch = per.draw_scratch(tree.depth, n_excl, "cuda")
    for _ in range(2):
        leaf, w = per.sum_tree_sample(tree.tree, r01, 0.6, n_leaves, depth=tree.depth, exclude_idx=excl, scratch=scratch)
        leaf_p, w_p = per.sum_tree_sample_plain(tree.tree, r01, 0.6, n_leaves, depth=tree.depth, exclude_idx=excl)
        torch.cuda.synchronize()
        assert torch.equal(leaf, leaf_p) and ((w - w_p).abs() <= 1e-6 * w_p.abs()).all()


def _device_ops(fn) -> int:
    """The device operations (kernels, fills, copies) one call of ``fn``
    makes, counted by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["write", "update", "scatter"])
@pytest.mark.parametrize("lanes", [1, 255, 256, 1024, 1025, 16384, 65536])
def test_sum_tree_writes_one_launch_at_the_method_boundaries(kind, lanes):
    """#6, #7 and #9 at lane counts on both sides of the one-block method
    (1,024 lanes) and at the path's shapes, on a 250,000-leaf tree whose
    internal nodes are not the sums of their children: one device operation
    a call, the tree equal to the plain version's from slot 1 (untouched
    nodes keep their bits), slot 0 untouched, the maxima exact, the owner
    scratch clean."""
    from sheeprl_tpu_torch.ops import per

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(lanes + len(kind))
    n_leaves = 250000
    tree = _tree(n_leaves, torch.rand(n_leaves, generator=g, device="cuda"))
    p = 1 << tree.depth
    tree.tree[1:p] = torch.randint(0, 1000, (p - 1,), generator=g, device="cuda").float() * 0.37
    leaf = torch.randint(0, n_leaves, (lanes,), generator=g, device="cuda", dtype=torch.int32)
    leaf[lanes // 2 : lanes // 2 + lanes // 4] = leaf[: lanes // 4]
    vals = torch.rand(lanes, generator=g, device="cuda") * 3
    vals[lanes // 2 : lanes // 2 + lanes // 8] = vals[: lanes // 8]
    active = torch.rand(lanes, generator=g, device="cuda") < 0.7
    active[0] = True
    shard_ids = torch.randint(0, 4, (lanes,), generator=g, device="cuda", dtype=torch.int32)
    shard_ids[0] = 1
    max_p = torch.tensor(0.5, device="cuda")
    owner = per.owner_scratch(tree.depth, "cuda")
    base = tree.tree.clone()
    a, b = base.clone(), base.clone()
    kernel = {
        "write": lambda t: (per.sum_tree_write(t, leaf, vals, active, depth=tree.depth, owner=owner), None)[1],
        "update": lambda t: per.sum_tree_update(t, max_p, leaf, vals, active, depth=tree.depth, owner=owner),
        "scatter": lambda t: per.sum_tree_scatter(t, leaf, vals, active, shard_ids, 1, depth=tree.depth, owner=owner)[1],
    }[kind]
    plain = {
        "write": lambda t: (per.sum_tree_write_plain(t, leaf, vals, active, depth=tree.depth), None)[1],
        "update": lambda t: per.sum_tree_update_plain(t, max_p, leaf, vals, active, depth=tree.depth),
        "scatter": lambda t: per.sum_tree_scatter_plain(t, leaf, vals, active, shard_ids, 1, depth=tree.depth)[1],
    }[kind]
    counter = getattr(per, f"sum_tree_{kind}")
    before = counter.launches
    got, want = kernel(a), plain(b)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.equal(a[1:], b[1:]) and float(a[0]) == float(base[0])
    if want is not None:
        assert got.shape == () and float(got) == float(want)
    assert bool((owner == -1).all())
    assert _device_ops(lambda: kernel(a)) == 1


@pytest.mark.cuda
def test_gather_transitions_after_a_ring_is_replaced():
    """A ring replaced by a new tensor behind the same key (and the old one
    freed, so its memory may come back) between calls: each call's bytes are
    those of the rings it was given."""
    from sheeprl_tpu_torch.ops.gather import gather_transitions, gather_transitions_plain

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(5)
    cap, n_envs, flat = 50, 4, 777
    bufs = {"obs": torch.randn(cap, n_envs, 24, generator=g, device="cuda"),
            "done": torch.randint(0, 2, (cap, n_envs, 1), generator=g, device="cuda", dtype=torch.uint8)}
    rows = torch.randint(0, cap, (flat,), generator=g, device="cuda", dtype=torch.int32)
    envs = torch.randint(0, n_envs, (flat,), generator=g, device="cuda", dtype=torch.int32)
    for step in range(4):
        out = gather_transitions(bufs, rows, envs, next_keys=("obs",))
        ref = gather_transitions_plain(bufs, rows, envs, next_keys=("obs",))
        torch.cuda.synchronize()
        for k in ref:
            assert torch.equal(out[k], ref[k]), (step, k)
        if step == 0:
            bufs["obs"] = torch.randn(cap, n_envs, 24, generator=g, device="cuda")  # a new ring, the old one alive
        else:
            del out, ref
            bufs = dict(bufs, done=None)
            bufs["done"] = torch.randint(0, 2, (cap, n_envs, 1), generator=g, device="cuda", dtype=torch.uint8) + step


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 4, 8, 16])
@pytest.mark.parametrize("flat", [1, 1000])
def test_gather_transitions_on_a_misaligned_ring(offset, flat):
    """A ring whose base is ``offset`` bytes into its allocation (a slice of
    a larger buffer) beside aligned rings, for one row and for 1,000: bytes
    exact, one launch."""
    from sheeprl_tpu_torch.ops.gather import gather_transitions, gather_transitions_plain

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(offset + flat)
    cap, n_envs = 31, 3
    raw = torch.randint(0, 256, (cap * n_envs * 96 + offset,), generator=g, device="cuda", dtype=torch.uint8)
    bufs = {"odd": raw[offset:].view(cap, n_envs, 96),
            "obs": torch.randn(cap, n_envs, 24, generator=g, device="cuda"),
            "flag": torch.randint(0, 2, (cap, n_envs), generator=g, device="cuda", dtype=torch.uint8)}
    rows = torch.randint(0, cap, (flat,), generator=g, device="cuda", dtype=torch.int32)
    rows[0] = cap - 1
    envs = torch.randint(0, n_envs, (flat,), generator=g, device="cuda", dtype=torch.int32)
    before = gather_transitions.launches
    out = gather_transitions(bufs, rows, envs, next_keys=("odd", "flag"))
    ref = gather_transitions_plain(bufs, rows, envs, next_keys=("odd", "flag"))
    torch.cuda.synchronize()
    assert gather_transitions.launches == before + 1
    assert list(out) == list(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape and torch.equal(out[k], ref[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [128, 512])
@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("steps", [1, 5, 64])
def test_gru_sequence_cluster_route_matches_plain(steps, batch, hidden):
    """The cluster route (the input product, then the recurrence on one
    cluster of 16 blocks) against the plain loop, with resets mid-sequence:
    forward within 1e-4 (chip_smoke's SEQ_TOL), the same bits twice, one
    input-product launch and one recurrence launch a call; at T = 5 also
    the gradients (efficient BPTT from the kernel's states) within 1e-3 of
    each gradient's largest magnitude (SEQ_GRAD_RTOL)."""
    from sheeprl_tpu_torch.ops import seq_gru

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert seq_gru.sequence_route(hidden, hidden, batch, seq_gru._smem_optin(0), sms) == "cluster"
    assert seq_gru.LIBRARY.load().sheeprl_gru_sequence_cluster_smem(hidden, batch) == seq_gru.cluster_smem_bytes(hidden, batch)
    args = _sequence_inputs(torch.Generator(device="cuda").manual_seed(steps * batch + hidden), steps, batch, hidden, hidden)
    before = (seq_gru.gru_sequence.launches, seq_gru.gru_input_product.launches)
    out = seq_gru.gru_sequence(*args)
    again = seq_gru.gru_sequence(*args)
    ref = seq_gru.gru_sequence_plain(*args)
    torch.cuda.synchronize()
    assert (seq_gru.gru_sequence.launches, seq_gru.gru_input_product.launches) == (before[0] + 2, before[1] + 2)
    assert out.shape == (steps, batch, hidden) and torch.equal(out, again)
    assert (out - ref).abs().max().item() <= 1e-4
    if steps == 5:
        diff = (0, 1, 2, 3, 4, 6)
        leaves = [a.requires_grad_(i in diff) for i, a in enumerate(args)]
        wanted = [leaves[i] for i in diff]
        up = torch.randn(steps, batch, hidden, device="cuda")
        got = torch.autograd.grad(seq_gru.gru_sequence(*leaves), wanted, up)
        want = torch.autograd.grad(seq_gru.gru_sequence_plain(*leaves), wanted, up)
        for a, b in zip(got, want):
            assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,xdim,route", [(512, 512, "cluster"), (768, 256, "grid")])
def test_gru_sequence_keeps_f32_accuracy(hidden, xdim, route):
    """Both routes at T = 64, B = 16 against the plain loop in float64
    within chip_smoke's SEQ_F32_TOL (2e-6), which an f32-accurate product
    meets and a ~16-bit one does not (tests/test_torch_seq_gru_routes.py)."""
    from chip_smoke import SEQ_F32_TOL, gru_sequence_f64
    from sheeprl_tpu_torch.ops import seq_gru

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert seq_gru.sequence_route(hidden, xdim, 16, seq_gru._smem_optin(0), sms) == route
    args = _sequence_inputs(torch.Generator(device="cuda").manual_seed(hidden), 64, 16, hidden, xdim)
    out = seq_gru.gru_sequence(*args)
    exact = gru_sequence_f64(torch, *args)
    assert (out.double() - exact).abs().max().item() <= SEQ_F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("steps,batch", [(5, 3), (64, 16)])
def test_gru_sequence_grid_route_matches_plain(steps, batch):
    """H = 768, X = 256 (eligible for the scan, W[:H] too large for 16
    blocks) takes the cooperative grid: forward within 1e-4, gradients
    within 1e-3, one launch a call and no input product."""
    from sheeprl_tpu_torch.ops import seq_gru

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert seq_gru.sequence_route(768, 256, batch, seq_gru._smem_optin(0), sms) == "grid"
    args = _sequence_inputs(torch.Generator(device="cuda").manual_seed(steps), steps, batch, 768, 256)
    before = (seq_gru.gru_sequence.launches, seq_gru.gru_input_product.launches)
    diff = (0, 1, 2, 3, 4, 6)
    leaves = [a.requires_grad_(i in diff) for i, a in enumerate(args)]
    wanted = [leaves[i] for i in diff]
    out = seq_gru.gru_sequence(*leaves)
    ref = seq_gru.gru_sequence_plain(*leaves)
    torch.cuda.synchronize()
    assert (seq_gru.gru_sequence.launches, seq_gru.gru_input_product.launches) == (before[0] + 1, before[1])
    assert (out - ref).abs().max().item() <= 1e-4
    up = torch.randn(steps, batch, 768, device="cuda")
    got = torch.autograd.grad(out, wanted, up)
    want = torch.autograd.grad(ref, wanted, up)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item()


@pytest.mark.cuda
def test_gru_input_product_matches_the_f32_product():
    """The cluster route's input product alone at the DV3-S shape (1,024
    rows x 512 @ 512 x 1,536) and at a ragged one: within 1e-5 of the f32
    product's largest magnitude, one launch a call."""
    from sheeprl_tpu_torch.ops.seq_gru import gru_input_product

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(9)
    for m, xdim, n in ((1024, 512, 1536), (3, 132, 384)):
        x = torch.randn(m, xdim, device="cuda", generator=g)
        w = torch.randn(xdim, n, device="cuda", generator=g) * xdim**-0.5
        before = gru_input_product.launches
        out = gru_input_product(x, w)
        ref = x @ w
        torch.cuda.synchronize()
        assert gru_input_product.launches == before + 1
        assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
def test_gather_windows_after_a_ring_is_replaced():
    """The window gather's plan is cached on the rings' pointers: a ring
    replaced by a new tensor behind the same key (the old one alive, then
    freed) between calls gives a new plan, and each call's bytes are those
    of the rings it was given; one launch and one device block a call."""
    from sheeprl_tpu_torch.ops import gather

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(8)
    cap, n_envs, seq_len, batch, n_samples = 61, 2, 9, 4, 3
    bufs = {"rgb": torch.randint(0, 256, (cap, n_envs, 16, 16, 3), generator=g, device="cuda", dtype=torch.uint8),
            "actions": torch.randn(cap, n_envs, 17, generator=g, device="cuda"),
            "odd": torch.randint(0, 256, (cap, n_envs, 3), generator=g, device="cuda", dtype=torch.uint8)}
    starts = torch.randint(0, cap, (n_samples * batch,), generator=g, device="cuda", dtype=torch.int32)
    starts[:2] = torch.tensor([cap - 1, cap - 4], dtype=torch.int32, device="cuda")
    envs = torch.randint(0, n_envs, (n_samples * batch,), generator=g, device="cuda", dtype=torch.int32)
    plans = []
    for step in range(4):
        before = gather.gather_windows.launches
        out = gather.gather_windows(bufs, starts, envs, seq_len=seq_len, batch_size=batch)
        ref = gather.gather_windows_plain(bufs, starts, envs, seq_len=seq_len, batch_size=batch)
        torch.cuda.synchronize()
        assert gather.gather_windows.launches == before + 1
        plans.append(gather._plan_for(bufs, ()))
        for k in ref:
            assert out[k].dtype == ref[k].dtype and torch.equal(out[k], ref[k]), (step, k)
        if step == 0:
            bufs["actions"] = torch.randn(cap, n_envs, 17, generator=g, device="cuda")
        else:
            del out, ref
            bufs = dict(bufs, odd=None)
            bufs["odd"] = torch.randint(0, 256, (cap, n_envs, 3), generator=g, device="cuda", dtype=torch.uint8) + step
    assert plans[0] is not plans[1]
    assert _device_ops(lambda: gather.gather_windows(bufs, starts, envs, seq_len=seq_len, batch_size=batch)) == 1
