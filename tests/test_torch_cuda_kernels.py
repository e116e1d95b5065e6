"""Kernels K1 (the centered Gram), K2 and K3 (KMeans assignment + stats)
and K4 (the UMAP tail accumulation) on a CUDA card, against float64
references and their plain versions.

These tests need the card: they are marked ``cuda`` and skip without one.
They import nothing of JAX, so on a machine with a card and no JAX they
run without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Tolerance for K1: the kernel and the plain version (cuBLAS, TF32 off) sum
in different orders, so both are held against a float64 Gram of the same
input, relative to max |C|: 1e-5 for float32 at these sizes, 1e-12 for
float64. K2 and K3: see their section below.
"""

import pytest
import torch

from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.ops.kernels import covariance as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    port_device.use_ieee_fp32_matmul()
    return torch.device("cuda")


def _rel_err(got: torch.Tensor, x: torch.Tensor, mean: torch.Tensor) -> float:
    b = x.double() - mean.double()
    ref = b.T @ b
    return ((got.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-300)).item()


# Widths at and around the 128-wide tile and its 4-wide vector loads (a
# width that is not a multiple of 4 takes the scalar variant), and row
# counts below one row step (k1.ROWS_PER_STEP) and off its multiple.
@pytest.mark.parametrize(
    "n,d,dtype,tol",
    [
        (1, 1, torch.float32, 1e-5),
        (31, 65, torch.float32, 1e-5),
        (4099, 130, torch.float32, 1e-5),
        (3, 1024, torch.float32, 1e-5),
        (1001, 5, torch.float32, 1e-5),
        (1001, 127, torch.float32, 1e-5),
        (2000, 128, torch.float32, 1e-5),
        (777, 129, torch.float32, 1e-5),
        (1500, 1023, torch.float32, 1e-5),
        (3000, 1024, torch.float32, 1e-5),
        (1001, 1025, torch.float32, 1e-5),
        (2048, 256, torch.float64, 1e-12),
        (333, 70, torch.float64, 1e-12),
        (333, 8, torch.float64, 1e-12),
        (1001, 63, torch.float64, 1e-12),
        (2048, 64, torch.float64, 1e-12),
        (777, 65, torch.float64, 1e-12),
        (4099, 1024, torch.float64, 1e-12),
        (5, 1024, torch.float64, 1e-12),
    ],
)
def test_kernel_matches_float64_gram(cuda, n, d, dtype, tol):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n * 1000 + d)
    x = torch.randn((n, d), generator=gen, device=cuda, dtype=dtype) + 2.0
    mean = x.mean(dim=0)
    before = k1.launches
    got = k1.centered_gram_cuda(x, mean)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    assert got.shape == (d, d) and got.dtype == dtype
    assert torch.equal(got, got.T)
    assert torch.equal(got, k1.centered_gram_cuda(x, mean))
    assert _rel_err(got, x, mean) <= tol
    assert _rel_err(k1.centered_gram_plain(x, mean), x, mean) <= tol


@pytest.mark.parametrize("d,dtype,tol", [(128, torch.float32, 1e-5), (64, torch.float64, 1e-12)])
def test_kernel_takes_misaligned_rows(cuda, d, dtype, tol):
    """x starting one element past a 16-byte boundary: a contiguous tensor
    the vector loads cannot take, so the scalar variant runs. It sums in
    the vector variant's order, so an aligned copy gives the same bits."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(d)
    n = 1003
    flat = torch.randn(n * d + 1, generator=gen, device=cuda, dtype=dtype) + 1.0
    x = flat[1:].view(n, d)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    mean = x.mean(dim=0)
    got = k1.centered_gram_cuda(x, mean)
    assert torch.equal(got, got.T)
    assert torch.equal(got, k1.centered_gram_cuda(x, mean))
    assert _rel_err(got, x, mean) <= tol
    assert torch.equal(got, k1.centered_gram_cuda(x.clone(), mean))


def test_split_plan_reads_the_occupancy_of_the_build(cuda):
    from spark_rapids_ml_tpu_torch.ops.kernels import _build

    lib = _build.load(k1.NAME)
    for dtype in (torch.float32, torch.float64):
        assert k1._blocks_per_sm(lib, dtype, torch.device("cuda", torch.cuda.current_device())) >= 1


def test_long_inputs_split_into_bounded_chunks_and_launch_slices(cuda, monkeypatch):
    """No running sum is longer than ``MAX_ROWS_PER_SPLIT`` rows: with the
    workspace capped at two chunks, 150,000 rows take three launches of
    at most 65,536 rows, whose Grams add up to the float64 Gram within the
    file's float32 tolerance; and the result is bitwise repeatable."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    x = torch.randn((150_000, 256), generator=gen, device=cuda) + 3.0
    mean = x.mean(dim=0)
    monkeypatch.setattr(k1, "WORKSPACE_BYTES", 2 * 256 * 256 * 4)
    assert k1.launch_rows(150_000, 256, torch.float32) == 2 * k1.MAX_ROWS_PER_SPLIT
    k1.reset_launches()
    got = k1.centered_gram_cuda(x, mean)
    assert k1.launches == 3
    assert _rel_err(got, x, mean) <= 1e-5
    assert torch.equal(got, got.T) and torch.equal(got, k1.centered_gram_cuda(x, mean))


def test_kernel_is_deterministic(cuda):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    x = torch.randn((50_000, 200), generator=gen, device=cuda)
    mean = x.mean(dim=0)
    assert torch.equal(k1.centered_gram_cuda(x, mean), k1.centered_gram_cuda(x, mean))


def test_empty_rows_give_zeros(cuda):
    x = torch.zeros((0, 9), device=cuda)
    out = k1.centered_gram_cuda(x, torch.zeros(9, device=cuda))
    assert torch.equal(out, torch.zeros((9, 9), device=cuda))


def test_moments_fold_cuda_blocks_through_k1_in_float64(cuda):
    """``ShiftedMoments.add_block`` on CUDA blocks: K1's float64 route,
    one launch a block at these sizes, within 1e-12 (relative to the
    largest entry) of the numpy route on the same rows, shift bitwise."""
    import numpy as np

    from spark_rapids_ml_tpu_torch.core.moments import ShiftedMoments

    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    x = torch.randn((100_003, 256), generator=gen, device=cuda) * 3.0 + 7.0
    splits = (0, 1, 65_536, 100_003)
    dev, host = ShiftedMoments(256), ShiftedMoments(256)
    k1.reset_launches()
    for a, b in zip(splits, splits[1:]):
        dev.add_block(x[a:b])
        host.add_block(x[a:b].cpu().numpy().astype(np.float64))
    assert k1.launches == 3
    assert np.array_equal(dev.shift, host.shift) and dev.n_rows == host.n_rows
    assert np.abs(dev.gram - host.gram).max() <= 1e-12 * np.abs(host.gram).max()
    assert np.abs(dev.sum - host.sum).max() <= 1e-12 * np.abs(host.sum).max()


def test_moments_without_a_k1_build_raise(cuda, monkeypatch):
    """No fallback: a CUDA block whose kernel cannot load raises, and the
    moments are left as they were."""
    from spark_rapids_ml_tpu_torch.core.moments import ShiftedMoments
    from spark_rapids_ml_tpu_torch.ops.kernels import _build

    def no_build(name):
        raise RuntimeError(f"{name}: no build")

    monkeypatch.setattr(_build, "load", no_build)
    mom = ShiftedMoments(8)
    with pytest.raises(RuntimeError, match="no build"):
        mom.add_block(torch.randn((32, 8), device=cuda))
    assert mom.n_rows == 0 and mom.shift is None and not mom.sum.any() and not mom.gram.any()


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.randn((64, 32), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k1.centered_gram_cuda(x.T, torch.zeros(64, device=cuda))
    with pytest.raises(TypeError, match="float32 or float64"):
        k1.centered_gram_cuda(x.half(), torch.zeros(32, device=cuda).half())
    with pytest.raises(ValueError, match="is on"):
        k1.centered_gram_cuda(x, torch.zeros(32))


# --- Kernels K2 (assign_stats_fused) and K3 (assign_stats_packed) ---------
#
# Held against kmeans_stats_f64, the float64 statistics of the same function
# on the operands the precision mode multiplies, scoring with the c2 the
# kernel returns: counts identical, sums within 1e-5 of max |sums|, the
# cost within 1e-5 relative plus 2e-6 of sum ||x||^2 (the cost is a
# difference of two sums of about that size, each rounded in fp32 per row;
# at one row the difference can be 100 times smaller than either). Planted blobs keep every row far from a Voronoi boundary, so
# the float32 scores cannot flip a label.

from spark_rapids_ml_tpu_torch.ops.kernels import kmeans as kk  # noqa: E402
from spark_rapids_ml_tpu_torch.utils.testing import kmeans_stats_f64  # noqa: E402

MODES = ("highest", "high", "default")


def _blobs(cuda, n, d, k, seed, scale=20.0):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    truth = scale * torch.randn((k, d), generator=gen, device=cuda)
    labels = torch.randint(0, k, (n,), generator=gen, device=cuda)
    x = truth[labels] + torch.randn((n, d), generator=gen, device=cuda)
    centers = (truth + 0.1 * torch.randn((k, d), generator=gen, device=cuda)).contiguous()
    return x.contiguous(), centers


def _hold(stats, x, centers, mode):
    sums, counts, cost, c2 = stats
    ref_sums, ref_counts, ref_cost, _ = kmeans_stats_f64(x, centers, mode, c2=c2)
    assert torch.equal(counts, ref_counts)
    scale = max(ref_sums.abs().max().item(), 1e-30)
    assert (sums.double() - ref_sums).abs().max().item() <= 1e-5 * scale
    x2 = (x.double() ** 2).sum().item()
    assert abs(cost.item() - ref_cost.item()) <= 1e-5 * abs(ref_cost.item()) + 2e-6 * x2
    c2_ref = (centers.double() ** 2).sum(dim=1)
    assert ((c2.double() - c2_ref).abs() <= 1e-6 * c2_ref.abs().clamp_min(1e-30)).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "n,d,k",
    [(1, 1, 1), (4099, 13, 7), (37, 5, 3), (3000, 16, 100), (2000, 40, 9), (1500, 64, 64),
     (1200, 100, 5), (513, 16, 1)]
    # k at the shared-memory limit of fused_feasible
    + [(4000, d, max(k for k in range(1, 2000) if kk.fused_feasible(d, k))) for d in (16, 64)],
)
def test_k2_matches_float64(cuda, mode, n, d, k):
    x, centers = _blobs(cuda, n, d, k, seed=n + d + k)
    before = kk.launches["assign_stats_fused"]
    stats = kk.assign_stats_fused(x, centers, mode)
    torch.cuda.synchronize()
    assert kk.launches["assign_stats_fused"] == before + 1
    _hold(stats, x, centers, mode)
    plain = kk.assign_stats_plain(x, centers, mode)
    assert torch.equal(stats[1], plain[1])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,d,k", [(1, 1, 1), (4099, 13, 7), (3000, 16, 16), (2000, 32, 32),
                                   (1500, 64, 64), (777, 20, 3)])
def test_k3_matches_float64_and_k2(cuda, mode, n, d, k):
    assert kk.packed_feasible(d, k)
    x, centers = _blobs(cuda, n, d, k, seed=7 * n + d + k)
    before = kk.launches["assign_stats_packed"]
    packed = kk.assign_stats_packed(x, centers, mode)
    torch.cuda.synchronize()
    assert kk.launches["assign_stats_packed"] == before + 1
    _hold(packed, x, centers, mode)
    fused = kk.assign_stats_fused(x, centers, mode)
    assert torch.equal(packed[1], fused[1])
    assert torch.equal(packed[3], fused[3])
    scale = max(fused[0].abs().max().item(), 1e-30)
    assert (packed[0] - fused[0]).abs().max().item() <= 1e-6 * scale
    assert abs(packed[2].item() - fused[2].item()) <= 1e-6 * abs(fused[2].item())


# K3's own cases: sub-tiles of 64 rows a warp at group width 16 (32 at 32
# and 64), rings of cp.async stages, a 16-byte copy route for rows that are
# 16-byte aligned and a 4-byte one otherwise. Centers 16 noise units apart
# along a +-1 diagonal keep every row far from a Voronoi boundary at any d,
# so float32 and float64 labels agree.


def _separated(cuda, n, d, k, seed):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    signs = torch.where(torch.arange(d, device=cuda) % 2 == 0, 1.0, -1.0)
    truth = 16.0 * torch.arange(k, device=cuda, dtype=torch.float32)[:, None] * signs[None, :]
    labels = torch.randint(0, k, (n,), generator=gen, device=cuda)
    x = truth[labels] + torch.randn((n, d), generator=gen, device=cuda)
    centers = (truth + 0.1 * torch.randn((k, d), generator=gen, device=cuda)).contiguous()
    return x.contiguous(), centers


def _kg(d):
    return kk._packed_geometry(d + ((-d) % 8), 1)[2]


def _hold_k3(packed, fused, x, centers, mode):
    _hold(packed, x, centers, mode)
    assert torch.equal(packed[1], fused[1])  # the labels' counts, bitwise K2's
    assert torch.equal(packed[3], fused[3])
    scale = max(fused[0].abs().max().item(), 1e-30)
    assert (packed[0] - fused[0]).abs().max().item() <= 1e-6 * scale
    assert abs(packed[2].item() - fused[2].item()) <= 1e-6 * abs(fused[2].item())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k_at", ["k=1", "k=kg"])
@pytest.mark.parametrize("d", [1, 3, 13, 16, 20, 32, 64])
@pytest.mark.parametrize("n", [5, 4099, 600_001], ids=["below_a_subtile", "off_a_subtile", "many_stages"])
def test_k3_shapes_match_float64_k2_and_repeat(cuda, n, d, k_at, mode):
    k = 1 if k_at == "k=1" else _kg(d)
    assert kk.packed_feasible(d, k)
    x, centers = _separated(cuda, n, d, k, seed=n + 31 * d + k)
    before = kk.launches["assign_stats_packed"]
    packed = kk.assign_stats_packed(x, centers, mode)
    again = kk.assign_stats_packed(x, centers, mode)
    torch.cuda.synchronize()
    assert kk.launches["assign_stats_packed"] == before + 2
    _hold_k3(packed, kk.assign_stats_fused(x, centers, mode), x, centers, mode)
    for u, v in zip(packed, again):
        assert torch.equal(u, v)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [4, 16, 20, 32, 64])
def test_k3_misaligned_rows_give_the_aligned_results(cuda, d, mode):
    """A contiguous x whose data_ptr() is only 4-byte aligned takes the
    4-byte copy route; its results are bitwise those of an aligned copy."""
    n = 50_003
    x, centers = _separated(cuda, n, d, _kg(d), seed=d)
    buf = torch.empty(n * d + 1, device=cuda)
    xm = buf[1:].view(n, d)
    xm.copy_(x)
    assert xm.is_contiguous() and xm.data_ptr() % 16 != 0 and x.data_ptr() % 16 == 0
    aligned = kk.assign_stats_packed(x, centers, mode)
    misaligned = kk.assign_stats_packed(xm, centers, mode)
    for u, v in zip(aligned, misaligned):
        assert torch.equal(u, v)
    _hold_k3(misaligned, kk.assign_stats_fused(x, centers, mode), x, centers, mode)


@pytest.mark.parametrize("assign", [kk.assign_stats_fused, kk.assign_stats_packed])
def test_no_rows_give_zero_stats(cuda, assign):
    x = torch.zeros((0, 5), device=cuda)
    centers = torch.randn((3, 5), device=cuda)
    sums, counts, cost, c2 = assign(x, centers)
    assert torch.equal(sums, torch.zeros((3, 5), device=cuda))
    assert torch.equal(counts, torch.zeros(3, dtype=torch.int64, device=cuda))
    assert cost.item() == 0.0
    assert torch.allclose(c2, (centers * centers).sum(dim=1), rtol=1e-6)


@pytest.mark.parametrize("assign", [kk.assign_stats_fused, kk.assign_stats_packed])
def test_ties_go_to_the_lowest_index(cuda, assign):
    x, centers = _blobs(cuda, 2000, 8, 4, seed=3)
    dup = torch.cat([centers, centers]).contiguous()  # centers j and j + 4 tie exactly
    counts = assign(x, dup)[1]
    assert counts[4:].sum().item() == 0
    assert torch.equal(counts[:4], assign(x, centers)[1])


@pytest.mark.parametrize("assign,k", [(kk.assign_stats_fused, 100), (kk.assign_stats_packed, 16)])
@pytest.mark.parametrize("mode", MODES)
def test_k2_k3_are_bitwise_repeatable(cuda, assign, k, mode):
    x, centers = _blobs(cuda, 300_000, 16, k, seed=11)
    a = assign(x, centers, mode)
    b = assign(x, centers, mode)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_k2_k3_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn((64, 16), device=cuda)
    c = torch.randn((4, 16), device=cuda)
    for assign in (kk.assign_stats_fused, kk.assign_stats_packed):
        with pytest.raises(TypeError, match="float32"):
            assign(x.double(), c.double())
        with pytest.raises(ValueError, match="contiguous"):
            assign(torch.randn((16, 64), device=cuda).T, c)
        with pytest.raises(ValueError, match="width"):
            assign(x, torch.randn((4, 15), device=cuda))
        with pytest.raises(ValueError, match="is on|are on"):
            assign(x, c.cpu())
        with pytest.raises(ValueError, match="precision"):
            assign(x, c, "fp8")
    with pytest.raises(ValueError, match="packing infeasible"):
        kk.assign_stats_packed(x, torch.randn((17, 16), device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        kk.assign_stats_fused(torch.randn((8, 1024), device=cuda), torch.randn((100, 1024), device=cuda))


# K2's own cases. Two variants: the warp variant (d <= 64 while
# fused_warps(d, k, mode) > 0: sub-tiles of 32 * rows rows a warp, a
# cp.async stage, sums owned by feature) and the sort variant (d > 64, or
# k past the warp variant's shared memory).


def _sorted_by_label(x, centers, mode):
    """x reordered so that equal labels are adjacent: every warp's rows
    share one label except at a cluster's edge."""
    labels = kmeans_stats_f64(x, centers, mode)[3]
    return x[torch.argsort(labels, stable=True)].contiguous()


def _k2_repeat(x, centers, mode):
    got = kk.assign_stats_fused(x, centers, mode)
    again = kk.assign_stats_fused(x, centers, mode)
    for u, v in zip(got, again):
        assert torch.equal(u, v)
    return got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,d,k", [(300_001, 16, 100), (300_001, 16, 16), (100_003, 32, 30),
                                   (100_003, 64, 20), (20_000, 100, 12)])
def test_k2_sorted_labels_match_float64_and_k3(cuda, n, d, k, mode):
    x, centers = _blobs(cuda, n, d, k, seed=n + d + k)
    xs = _sorted_by_label(x, centers, mode)
    got = _k2_repeat(xs, centers, mode)
    _hold(got, xs, centers, mode)
    assert torch.equal(got[1], kk.assign_stats_fused(x, centers, mode)[1])
    if kk.packed_feasible(d, k):
        _hold_k3(kk.assign_stats_packed(xs, centers, mode), got, xs, centers, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d,k", [(16, 100), (13, 7), (64, 40), (80, 9)])
def test_k2_every_row_in_one_cluster(cuda, d, k, mode):
    x, centers = _blobs(cuda, 200_003, d, k, seed=d * k)
    x = (centers[2] + torch.randn(x.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(d))).contiguous()
    got = _k2_repeat(x, centers, mode)
    _hold(got, x, centers, mode)
    assert got[1][2].item() == x.shape[0]


def _warp_limit(d, mode):
    return max(k for k in range(1, 2000) if kk.fused_warps(d, k, mode) > 0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("at", ["last_warp_k", "first_sort_k", "feasible_limit"])
@pytest.mark.parametrize("d", [13, 16, 32, 64])
def test_k2_variant_boundaries_match_float64(cuda, d, at, mode):
    """k at the last shape of the warp variant, the first of the sort
    variant, and the limit of fused_feasible, for each register width."""
    limit = max(k for k in range(1, 2000) if kk.fused_feasible(d, k))
    k = {"last_warp_k": _warp_limit(d, mode), "first_sort_k": _warp_limit(d, mode) + 1,
         "feasible_limit": limit}[at]
    assert kk.fused_feasible(d, k)
    assert (kk.fused_warps(d, k, mode) > 0) == (at == "last_warp_k")
    x, centers = _blobs(cuda, 4000, d, k, seed=d + k)
    got = _k2_repeat(x, centers, mode)
    _hold(got, x, centers, mode)
    assert torch.equal(got[1], kk.assign_stats_plain(x, centers, mode)[1])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d,k", [(13, 40), (16, 100), (64, 30), (64, 200)])
def test_k2_misaligned_rows_give_the_aligned_results(cuda, d, k, mode):
    """A contiguous x whose data_ptr() is only 4-byte aligned takes the
    4-byte copy route of the warp variant (d = 13 takes it either way; k =
    200 at d = 64 runs the sort variant); the results are bitwise those of
    an aligned copy."""
    n = 50_003
    x, centers = _separated(cuda, n, d, k, seed=d + k)
    buf = torch.empty(n * d + 1, device=cuda)
    xm = buf[1:].view(n, d)
    xm.copy_(x)
    assert xm.is_contiguous() and xm.data_ptr() % 16 != 0 and x.data_ptr() % 16 == 0
    aligned = kk.assign_stats_fused(x, centers, mode)
    misaligned = kk.assign_stats_fused(xm, centers, mode)
    for u, v in zip(aligned, misaligned):
        assert torch.equal(u, v)
    _hold(misaligned, x, centers, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [1, 5, 127, 129, 1_537, 65_537])
@pytest.mark.parametrize("d,k", [(16, 100), (20, 50), (64, 30)])
def test_k2_ragged_rows_match_float64_and_repeat(cuda, n, d, k, mode):
    """n below one sub-tile, off one, and off a round of sub-tiles."""
    x, centers = _blobs(cuda, n, d, k, seed=3 * n + d + k)
    got = _k2_repeat(x, centers, mode)
    _hold(got, x, centers, mode)
    assert torch.equal(got[1], kk.assign_stats_plain(x, centers, mode)[1])


@pytest.mark.parametrize("d,k", [(5, 3), (16, 100), (16, 900), (100, 7)])
def test_k2_no_rows_give_zero_stats_in_both_variants(cuda, d, k):
    x = torch.zeros((0, d), device=cuda)
    centers = torch.randn((k, d), device=cuda)
    sums, counts, cost, c2 = kk.assign_stats_fused(x, centers)
    assert torch.equal(sums, torch.zeros((k, d), device=cuda))
    assert torch.equal(counts, torch.zeros(k, dtype=torch.int64, device=cuda))
    assert cost.item() == 0.0
    assert torch.allclose(c2, (centers * centers).sum(dim=1), rtol=1e-6)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d,k", [(8, 4), (16, 300), (80, 6)])
def test_k2_ties_go_to_the_lowest_index_in_both_variants(cuda, d, k, mode):
    x, centers = _blobs(cuda, 3000, d, k, seed=d + k)
    dup = torch.cat([centers, centers]).contiguous()  # centers j and j + k tie exactly
    counts = kk.assign_stats_fused(x, dup, mode)[1]
    assert counts[k:].sum().item() == 0
    assert torch.equal(counts[:k], kk.assign_stats_fused(x, centers, mode)[1])


@pytest.mark.parametrize("mode", MODES)
def test_k2_rows_past_the_norm_limit_take_score_itself(cuda, mode):
    """Rows whose ||x||^2 passes 2^124 (blobs scaled by 2^56; few enough
    rows that the cost stays below float32's largest value) are scored by
    score() itself rather than its one-FFMA form; the labels are still
    float64's and bitwise K3's."""
    x, centers = _blobs(cuda, 1000, 16, 16, seed=56)
    x, centers = x * 2.0 ** 56, (centers * 2.0 ** 56).contiguous()
    assert (x.double() ** 2).sum(dim=1).max().item() > 2.0 ** 124
    got = _k2_repeat(x, centers, mode)
    _hold(got, x, centers, mode)
    packed = kk.assign_stats_packed(x, centers, mode)
    assert torch.equal(packed[1], got[1]) and torch.equal(packed[3], got[3])


def test_k2_variant_and_plan_match_the_source(cuda):
    import ctypes

    from spark_rapids_ml_tpu_torch.ops.kernels import _build

    lib = _build.load(kk.FUSED_NAME)
    warps = lib.kmeans_assign_stats_warps
    warps.argtypes, warps.restype = [ctypes.c_int] * 3, ctypes.c_int
    per_sm = lib.kmeans_assign_stats_blocks_per_sm
    per_sm.argtypes, per_sm.restype = [ctypes.c_int] * 3, ctypes.c_int
    for mode, prec in kk.PRECISIONS.items():
        for d in (1, 13, 16, 17, 32, 40, 64, 65, 200):
            for k in (1, 7, 100, 300, 560, 600, 971):
                if not kk.fused_feasible(d, k):
                    continue
                assert warps(d, k, prec) == kk.fused_warps(d, k, mode), (d, k, mode)
                assert per_sm(d, k, prec) >= 1, (d, k, mode)
    assert warps(16, 100, 7) == -1


def test_shared_memory_rule_matches_the_source(cuda):
    import ctypes

    from spark_rapids_ml_tpu_torch.ops.kernels import _build

    lib = _build.load(kk.FUSED_NAME)
    fn = lib.kmeans_assign_stats_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    for d, k in [(1, 1), (13, 7), (16, 100), (33, 50), (64, 64), (100, 200), (16, 1000)]:
        assert fn(d, k) == kk.fused_shared_bytes(d, k)
    packed = _build.load(kk.PACKED_NAME).kmeans_assign_packed_threads
    packed.argtypes, packed.restype = [ctypes.c_int], ctypes.c_int
    assert [packed(dg) for dg in (16, 32, 64)] == [kk.packed_threads(dg) for dg in (16, 32, 64)]


def test_fused_fit_on_the_card_matches_the_xla_fit(cuda):
    from spark_rapids_ml_tpu_torch.clustering import KMeans

    x, centers = _blobs(cuda, 400_000, 16, 20, seed=5)
    for k in (20, 12):
        init = centers[:k].cpu().numpy()
        kk.reset_launches()
        fused = KMeans().setK(k).setInitialModel(init).setBackend("auto").fit(x)
        name = "assign_stats_packed" if k <= 16 else "assign_stats_fused"
        assert kk.launches[name] > 0
        xla = KMeans().setK(k).setInitialModel(init).setBackend("xla").fit(x)
        assert fused.numIter == xla.numIter
        assert abs(fused.clusterCenters() - xla.clusterCenters()).max() <= 1e-3
        assert abs(fused.trainingCost - xla.trainingCost) <= 1e-4 * xla.trainingCost


# --- Kernel K4 (tail_accumulate) ------------------------------------------
#
# Held against an on-card float64 index_add_ of the same edge rows: within
# 1e-6 of max |out| (the kernel sums in float64 and rounds once, so it lies
# within half an ulp of the exact sum; the float32 plain version, whose
# order on the card is not fixed, is held at 1e-5 of the row's sum of |g|).

from spark_rapids_ml_tpu_torch.ops.kernels import umap as k4  # noqa: E402


def _edges(cuda, n, k, dim, seed, tails=None):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    if tails is None:
        tails = torch.randint(0, n, (n, k), generator=gen, device=cuda)
    g = torch.randn((n * k, dim), generator=gen, device=cuda)
    return tails, g


def _hold_k4(out, g, plan, tails):
    ref = torch.zeros((plan.n, plan.dim), dtype=torch.float64, device=g.device)
    ref.index_add_(0, tails.reshape(-1).long(), g.double())
    scale = max(ref.abs().max().item(), 1e-30)
    assert out.shape == (plan.n, plan.dim) and out.dtype == torch.float32
    assert (out.double() - ref).abs().max().item() <= 1e-6 * scale
    mass = torch.zeros_like(ref).index_add_(0, tails.reshape(-1).long(), g.double().abs())
    plain = k4.tail_accumulate_plain(g, plan)
    assert ((plain.double() - ref).abs() <= 1e-5 * mass + 1e-30).all()


@pytest.mark.parametrize(
    "n,k,dim",
    [(1, 1, 2), (600, 8, 2), (257, 5, 3), (1024, 15, 2), (130, 3, 10), (500, 7, 1),
     (300, 4, 128), (50_000, 15, 2)],
)
def test_k4_matches_float64_index_add(cuda, n, k, dim):
    tails, g = _edges(cuda, n, k, dim, seed=n + k + dim)
    plan = k4.build_tail_plan(tails, n, dim)
    assert torch.equal(plan.perm.long(), torch.argsort(tails.reshape(-1).cpu(), stable=True).to(cuda))
    before = k4.launches["tail_accumulate"]
    out = k4.tail_accumulate(g, plan)
    torch.cuda.synchronize()
    assert k4.launches["tail_accumulate"] == before + 1
    _hold_k4(out, g, plan, tails)
    assert torch.equal(out, k4.tail_accumulate(g, plan))


def _pattern_tails(cuda, pattern, seed):
    """Tails that drive each path of the kernel: one hub of 32·U + 1 edges
    (the whole warp, two rounds), and warps whose rows mix empty, short and
    long runs (a long run sends its warp down the row-by-row path)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    u = k4.EDGES_PER_LANE
    if pattern == "hub_32u_plus_1":
        n, k = 2000, 3
        tails = torch.randint(0, n, (n, k), generator=gen, device=cuda)
        tails[tails == 17] = 18
        tails.view(-1)[: 32 * u + 1] = 17  # exactly 32·U + 1 in-edges
    else:
        n, k = 4000, 5
        tails = torch.randint(0, n // 2, (n, k), generator=gen, device=cuda) * 2  # odd rows empty
        flat = tails.view(-1)
        for i, row in enumerate(range(0, n, 40)):  # a long run every tenth warp
            flat[200 * i:200 * i + k4.SHORT_RUN + 1 + i] = row
    return n, k, tails


@pytest.mark.parametrize("pattern", ["hub_32u_plus_1", "mixed_groups"])
@pytest.mark.parametrize("dim", [1, 2, 3, 10, 128])
def test_k4_degree_patterns(cuda, pattern, dim):
    n, k, tails = _pattern_tails(cuda, pattern, seed=dim)
    _, g = _edges(cuda, n, k, dim, seed=dim + 1, tails=tails)
    plan = k4.build_tail_plan(tails, n, dim)
    indeg = torch.bincount(tails.reshape(-1), minlength=n)
    assert int(indeg.max()) > k4.SHORT_RUN and int((indeg == 0).sum()) > 0
    out = k4.tail_accumulate(g, plan)
    _hold_k4(out, g, plan, tails)
    assert torch.equal(out, k4.tail_accumulate(g, plan))
    assert torch.count_nonzero(out[indeg == 0]) == 0


@pytest.mark.parametrize("dim", [1, 2, 3, 10, 128])
def test_k4_one_hub_takes_every_edge(cuda, dim):
    n, k = 4000, 15
    tails = torch.full((n, k), 1234, dtype=torch.int64, device=cuda)
    _, g = _edges(cuda, n, k, dim, seed=3, tails=tails)
    plan = k4.build_tail_plan(tails, n, dim)
    out = k4.tail_accumulate(g, plan)
    _hold_k4(out, g, plan, tails)
    assert torch.equal(out, k4.tail_accumulate(g, plan))
    assert torch.count_nonzero(out[:1234]) == 0 and torch.count_nonzero(out[1235:]) == 0


def test_k4_rows_without_in_edges_are_zero(cuda):
    n, k, dim = 1000, 6, 3
    gen = torch.Generator(device=cuda)
    gen.manual_seed(9)
    tails = 2 * torch.randint(0, n // 2, (n, k), generator=gen, device=cuda)  # odd rows get none
    _, g = _edges(cuda, n, k, dim, seed=9, tails=tails)
    plan = k4.build_tail_plan(tails, n, dim)
    out = k4.tail_accumulate(g, plan)
    _hold_k4(out, g, plan, tails)
    assert torch.count_nonzero(out[1::2]) == 0


def test_k4_is_bitwise_repeatable(cuda):
    tails, g = _edges(cuda, 50_000, 15, 2, seed=13)
    plan = k4.build_tail_plan(tails, 50_000, 2)
    assert torch.equal(k4.tail_accumulate(g, plan), k4.tail_accumulate(g, plan))


def test_k4_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    tails, g = _edges(cuda, 100, 4, 2, seed=1)
    plan = k4.build_tail_plan(tails, 100, 2)
    with pytest.raises(TypeError, match="float32"):
        k4.tail_accumulate(g.double(), plan)
    with pytest.raises(ValueError, match="contiguous"):
        k4.tail_accumulate(torch.randn((2, 400), device=cuda).T, plan)
    with pytest.raises(ValueError, match="!= plan"):
        k4.tail_accumulate(g[:-1].contiguous(), plan)
    with pytest.raises(ValueError, match="!= plan"):
        k4.tail_accumulate(torch.randn((400, 3), device=cuda), plan)
    cpu_plan = k4.build_tail_plan(tails.cpu(), 100, 2)
    with pytest.raises(ValueError, match="is on"):
        k4.tail_accumulate(g, cpu_plan)


def test_k4_runs_every_epoch_of_a_fit(cuda):
    from spark_rapids_ml_tpu_torch.manifold import UMAP

    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    x = torch.randn((3000, 16), generator=gen, device=cuda)
    x[:1500, 0] += 8.0
    k4.reset_launches()
    model = UMAP().setNNeighbors(10).setNEpochs(30).setInit("random").setSeed(1).fit(x)
    assert k4.launches["tail_accumulate"] == 30
    assert bool(torch.isfinite(model._emb_raw).all())
    model.transform(x[:100])
    assert k4.launches["tail_accumulate"] == 30


# --- Kernel K5 (k-means++ seeding) -----------------------------------------
#
# K5 and the torch loop draw the same uniforms from generators seeded
# alike, so on planted blobs (no two candidates' scores or potentials
# within float32 rounding of each other) they pick the same rows in the
# same order: the centres are compared bitwise. K5's D² (sum of (x − c)²)
# is held to a float64 one of the same rows and centres within 1e-5
# relative, row by row (a sum of 64 rounded squares errs by ~64 ulp; the
# torch loop's expansion x² − 2x·c + c² errs by far more near a centre).

from spark_rapids_ml_tpu_torch.ops import kmeans as ops_kmeans  # noqa: E402


def _seed_rows(cuda, n, d, blobs, seed, scale=50.0):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    truth = scale * torch.randn((blobs, d), generator=gen, device=cuda)
    pick = torch.randint(0, blobs, (n,), generator=gen, device=cuda)
    return (truth[pick] + torch.randn((n, d), generator=gen, device=cuda)).contiguous()


def _seed_gen(cuda, seed):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    return gen


def _hold_k5(x, w, k, seed=2147483901):
    cuda = x.device
    got = kk.seed_plusplus_cuda(x, w, _seed_gen(cuda, seed), k)
    again = kk.seed_plusplus_cuda(x, w, _seed_gen(cuda, seed), k)
    ones = torch.ones(x.shape[0], device=cuda) if w is None else w
    loop = ops_kmeans.kmeans_plusplus_loop(x, ones, _seed_gen(cuda, seed), k)
    assert torch.equal(got.centers, loop)
    assert torch.equal(x[got.rows], got.centers)
    assert torch.equal(got.centers, again.centers) and torch.equal(got.rows, again.rows)
    assert torch.equal(got.md, again.md)
    if k > 1:
        c = got.centers[: k - 1].double()
        ref = torch.stack([((x.double() - ci) ** 2).sum(dim=1) for ci in c]).min(dim=0).values
        assert ((got.md.double() - ref).abs() <= 1e-5 * ref).all()
    return got


@pytest.mark.parametrize("n,d,k", [
    (1, 16, 1), (3, 16, 2), (4, 16, 2), (5, 16, 5), (6, 16, 5), (1_000_003, 16, 100),  # ragged n: t, t + 1
    (20_001, 1, 5), (20_001, 3, 5), (20_001, 16, 5), (20_001, 17, 5), (20_001, 64, 5),  # widths; 64 the limit
    (100_003, 16, 2), (100_003, 16, 5), (100_003, 16, 100),  # k
])
def test_k5_picks_the_torch_loops_rows(cuda, n, d, k):
    x = _seed_rows(cuda, n, d, min(max(k, 2), 100), seed=n + d)
    _hold_k5(x, None, k)


def test_k5_with_its_widest_potential_slots(cuda):
    # k = 16,385 draws t = 17 candidates a step, so K5b keeps 32 float64
    # potentials a thread. Rows on an integer grid: every D² is exact in
    # both routes (the loop's expansion included), so no near-tie of the
    # 16,384 steps can part them.
    gen = _seed_gen(cuda, 12)
    x = torch.randint(-50, 50, (20_000, 4), generator=gen, device=cuda).float()
    assert ops_kmeans.seed_candidates(16_385, 20_000) == 17
    _hold_k5(x, None, 16_385)


def test_k5_never_picks_a_row_of_weight_zero(cuda):
    x = _seed_rows(cuda, 300_001, 16, 20, seed=3)
    x[:1000] += 400.0  # a far blob, all of weight 0
    w = torch.ones(x.shape[0], device=cuda)
    w[:1000] = 0.0
    w[::3] = 0.0
    got = _hold_k5(x, w, 30)
    assert bool((w[got.rows] > 0).all())


def test_k5_repeats_the_first_row_on_duplicate_rows(cuda):
    x = _seed_rows(cuda, 1, 16, 1, seed=4).repeat(50_000, 1)
    got = _hold_k5(x, None, 6)
    assert bool((got.rows == got.rows[0]).all())


@pytest.mark.parametrize("k", [4, 5, 9])
def test_k5_past_the_distinct_rows_repeats_the_first_row(cuda, k):
    # Three distinct rows of weight 1, a thousand copies each, and ten of
    # weight 0 apart: k above the three, within n. Both routes choose the
    # three rows first, in one order. After them no row of weight > 0 lies
    # off a chosen centre: K5's sum of (x − c)² gives every copy D² = 0,
    # so every slot takes the first centre's row, and K5 never takes a row
    # of weight 0. The torch loop's expansion x² − 2x·c + c² may leave a
    # copy a rounding residue above 0 (about a fifth of such copies, on the
    # CPU and on an H100 alike), so it may draw a copy of any chosen centre
    # there instead: both are rows of x, and the two routes part.
    gen = _seed_gen(cuda, 21)
    points = 50.0 * torch.randn((3, 16), generator=gen, device=cuda)
    apart = 50.0 * torch.randn((10, 16), generator=gen, device=cuda) + 400.0
    x = torch.cat([points.repeat_interleave(1000, dim=0), apart])
    w = torch.cat([torch.ones(3000, device=cuda), torch.zeros(10, device=cuda)])
    order = torch.randperm(x.shape[0], generator=gen, device=cuda)
    x, w = x[order].contiguous(), w[order].contiguous()
    got = kk.seed_plusplus_cuda(x, w, _seed_gen(cuda, 22), k)
    loop = ops_kmeans.kmeans_plusplus_loop(x, w, _seed_gen(cuda, 22), k)
    assert torch.equal(x[got.rows], got.centers) and bool((w[got.rows] > 0).all())
    assert torch.equal(got.centers[:3], loop[:3])
    assert sorted(map(tuple, got.centers[:3].tolist())) == sorted(map(tuple, points.tolist()))
    assert bool((got.rows[3:] == got.rows[0]).all())
    assert bool((got.md == 0).logical_or(w == 0).all())
    assert all(bool((x == c).all(dim=1).any()) for c in loop)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_k5_fills_short_slots_with_the_first_row_not_a_row_of_weight_zero(cuda, seed):
    # A thousand copies of one row, two rows close to each other apart
    # from it, and two thousand rows of weight 0 at their midpoint; k = 3
    # draws t = 4 candidates a step. Once a copy is chosen, two rows have
    # a finite score: K5 fills the other two slots with the first centre's
    # row and chooses the close rows. The torch loop keeps whatever rows
    # topk returns at −inf there, and a midpoint row, which halves the
    # close rows' D², can win: it may choose a row of weight 0.
    gen = _seed_gen(cuda, seed)
    far = 50.0 * torch.randn(16, generator=gen, device=cuda) + 200.0
    mid = 50.0 * torch.randn(16, generator=gen, device=cuda)
    e = 0.5 * torch.randn(16, generator=gen, device=cuda)
    x = torch.cat([far.repeat(1000, 1), (mid + e)[None], (mid - e)[None], mid.repeat(2000, 1)])
    w = torch.cat([torch.ones(1002, device=cuda), torch.zeros(2000, device=cuda)])
    order = torch.randperm(x.shape[0], generator=gen, device=cuda)
    x, w = x[order].contiguous(), w[order].contiguous()
    got = kk.seed_plusplus_cuda(x, w, _seed_gen(cuda, seed + 10), 3)
    loop = ops_kmeans.kmeans_plusplus_loop(x, w, _seed_gen(cuda, seed + 10), 3)
    assert torch.equal(x[got.rows], got.centers) and bool((w[got.rows] > 0).all())
    want = sorted(map(tuple, torch.stack([far, mid + e, mid - e]).tolist()))
    assert sorted(map(tuple, got.centers.tolist())) == want
    assert all(bool((x == c).all(dim=1).any()) for c in loop)


def test_k5_seeding_makes_no_host_sync(cuda):
    x = _seed_rows(cuda, 200_003, 16, 100, seed=5)
    mask = torch.ones(x.shape[0], device=cuda)
    gen = _seed_gen(cuda, 7)
    ops_kmeans.kmeans_plusplus_init(x, mask, _seed_gen(cuda, 7), 100)  # builds K5
    torch.cuda.synchronize()
    kk.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        centers = ops_kmeans.kmeans_plusplus_init(x, mask, gen, 100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kk.launches["seed_select"] == 100 and kk.launches["seed_potentials"] == 99
    assert torch.equal(centers, ops_kmeans.kmeans_plusplus_loop(x, mask, _seed_gen(cuda, 7), 100))


def test_a_mesh_fit_on_one_card_equals_the_k5_fit(cuda):
    from spark_rapids_ml_tpu_torch.clustering import KMeans
    from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh, shard_tensor_rows

    x = _seed_rows(cuda, 400_003, 16, 20, seed=6)
    mesh = make_mesh((4, 1), devices=[cuda] * 4)
    shards = ops_kmeans.as_row_shards(shard_tensor_rows(x, mesh))
    assert not ops_kmeans.seeding_on_k5(shards, 20, "highest")
    mask = torch.ones(x.shape[0], device=cuda)
    k5 = ops_kmeans.kmeans_plusplus_init(x, mask, _seed_gen(cuda, 11), 20)
    assert torch.equal(ops_kmeans.kmeans_plusplus_init(shards, None, _seed_gen(cuda, 11), 20), k5)
    kk.reset_launches()
    single = KMeans().setK(20).setSeed(11).fit(x)
    assert kk.launches["seed_select"] == 20
    meshed = KMeans(mesh=mesh).setK(20).setSeed(11).fit(x)
    assert single.numIter == meshed.numIter
    assert abs(single.clusterCenters() - meshed.clusterCenters()).max() <= 1e-3
    assert abs(single.trainingCost - meshed.trainingCost) <= 1e-4 * meshed.trainingCost


def test_k5_limits_match_the_source(cuda):
    import re

    from spark_rapids_ml_tpu_torch.ops.kernels import _build

    text = (_build.CSRC_DIR / f"{kk.SEED_NAME}.cu").read_text()
    ints = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert (ints["THREADS"], ints["D_MAX"], ints["T_MAX"]) == (kk.SEED_THREADS, kk.SEED_D_MAX, kk.SEED_T_MAX)
    for kernel in (kk.SEED_SELECT, kk.SEED_POTENTIALS):
        for d, t in ((1, 1), (16, 9), (64, 32)):
            assert kk._seed_blocks_per_sm(cuda, kernel, d, t) >= 1


def test_k5_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    gen = _seed_gen(cuda, 0)
    with pytest.raises(TypeError, match="float32"):
        kk.seed_plusplus(torch.zeros((10, 4), dtype=torch.float64, device=cuda), None, gen, 3)
    with pytest.raises(ValueError, match="beyond K5"):
        kk.seed_plusplus(torch.zeros((10, 65), device=cuda), None, gen, 3)
    with pytest.raises(ValueError, match="weights"):
        kk.seed_plusplus(torch.zeros((10, 4), device=cuda), torch.ones(10), gen, 3)
