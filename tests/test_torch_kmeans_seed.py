"""K-means++ seeding's two routes, on the CPU: which inputs take kernel K5
(``csrc/kmeans_seed.cu``) and which the torch loop, K5's launch plan, and
the torch loop's draws pinned as they were before K5 existed.

K5 itself runs only on a card; ``tests/test_torch_cuda_kernels.py`` holds
it against the torch loop there (marked ``cuda``).
"""

import re

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu_torch.ops import kmeans as ok
from spark_rapids_ml_tpu_torch.ops.kernels import _build
from spark_rapids_ml_tpu_torch.ops.kernels import kmeans as kk


class _Rows:
    """A stand-in for a tensor of rows on a device this machine lacks: the
    dispatch reads only its device, dtype and shape."""

    def __init__(self, n, d, dtype=torch.float32, cuda=True):
        self.shape = torch.Size((n, d))
        self.dtype = dtype
        self.is_cuda = cuda
        self.device = torch.device("cuda" if cuda else "cpu")


def _shards(*parts):
    offsets = list(np.cumsum([0] + [int(p.shape[0]) for p in parts[:-1]]))
    return ok.RowShards(list(parts), [None] * len(parts), offsets, sum(int(p.shape[0]) for p in parts),
                        parts[0].device)


@pytest.mark.parametrize("shards, k, precision, gang, on_k5", [
    (_shards(_Rows(20_000_000, 16)), 100, "highest", False, True),
    (_shards(_Rows(1_000, 64)), 2 ** 30, "highest", False, True),
    (_shards(_Rows(20_000_000, 16, cuda=False)), 100, "highest", False, False),
    (_shards(_Rows(20_000_000, 16, dtype=torch.float64)), 100, "highest", False, False),
    (_shards(_Rows(10_000_000, 16), _Rows(10_000_000, 16)), 100, "highest", False, False),
    (_shards(_Rows(20_000_000, 16)), 100, "highest", True, False),
    (_shards(_Rows(20_000_000, 65)), 100, "highest", False, False),
    (_shards(_Rows(1_000, 16)), 2 ** 31, "highest", False, False),
    (_shards(_Rows(20_000_000, 16)), 100, "high", False, False),
], ids=["cell", "k_at_the_limit", "cpu", "float64", "two_shards", "gang", "d_past_the_limit",
        "k_past_the_limit", "bf16_products"])
def test_the_seeding_routes_by_its_input(monkeypatch, shards, k, precision, gang, on_k5):
    monkeypatch.setattr(ok, "in_gang", lambda: gang)
    assert ok.seeding_on_k5(shards, k, precision) is on_k5


def test_a_mesh_fit_seeds_on_the_torch_loop():
    from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh, shard_tensor_rows

    x = torch.randn(64, 5)
    mesh = make_mesh((4, 1), devices=[torch.device("cpu")] * 4)
    assert not ok.seeding_on_k5(ok.as_row_shards(shard_tensor_rows(x, mesh)), 5, "highest")


@pytest.mark.parametrize("k, n, t", [(100, 20_000_000, 9), (2, 50, 3), (5, 50, 5), (1, 50, 2), (5, 5, 5),
                                     (100, 1, 1), (2 ** 30, 10 ** 9, 32), (2 ** 30 + 1, 10 ** 9, 33)])
def test_candidates_a_step(k, n, t):
    assert ok.seed_candidates(k, n) == t


def test_k5_constants_match_the_source():
    text = (_build.CSRC_DIR / f"{kk.SEED_NAME}.cu").read_text()
    ints = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert (ints["THREADS"], ints["D_MAX"], ints["T_MAX"]) == (kk.SEED_THREADS, kk.SEED_D_MAX, kk.SEED_T_MAX)


@pytest.mark.parametrize("d, t, feasible", [(16, 9, True), (1, 1, True), (64, 32, True), (65, 9, False),
                                            (16, 33, False), (0, 9, False), (16, 0, False)])
def test_k5_feasibility(d, t, feasible):
    assert kk.seed_feasible(d, t) is feasible


@pytest.mark.parametrize("n, sms, per_sm, blocks", [
    (20_000_000, 132, 4, 528),  # the cell: one wave
    (20_000_000, 132, 8, 1056),
    (1, 132, 4, 1),
    (256, 132, 4, 1),
    (257, 132, 4, 2),
    (1_000_003, 132, 8, 1056),
    (100_000, 132, 8, 391),  # fewer tiles than the wave
])
def test_k5_launch_plan(n, sms, per_sm, blocks):
    assert kk.seed_blocks(n, sms, per_sm) == blocks


def _planted():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(200, 6)) + np.repeat(rng.normal(scale=20, size=(5, 6)), 40, axis=0)
    w = np.ones(200)
    w[::7] = 0.0
    return x, w


# The rows the torch loop chose before K5 existed (same seed, same data).
@pytest.mark.parametrize("dtype, k, weighted, rows", [
    (torch.float32, 5, False, [153, 190, 118, 5, 59]),
    (torch.float32, 8, True, [153, 178, 118, 5, 59, 174, 135, 149]),
    (torch.float64, 5, False, [67, 185, 7, 112, 155]),
    (torch.float64, 8, True, [67, 185, 3, 114, 155, 102, 44, 165]),
])
def test_the_cpu_seeding_draws_what_it_drew(dtype, k, weighted, rows):
    x, w = _planted()
    xt = torch.from_numpy(x).to(dtype)
    mask = torch.from_numpy(w if weighted else np.ones(200)).to(dtype)
    centers = ok.kmeans_plusplus_init(xt, mask, torch.Generator().manual_seed(3), k)
    assert torch.equal(centers, xt[rows])


def test_the_wrapper_takes_the_torch_loop_on_the_cpu():
    x, w = _planted()
    xt, mask = torch.from_numpy(x).float(), torch.from_numpy(w).float()
    got = kk.seed_plusplus(xt, mask, torch.Generator().manual_seed(3), 8)
    want = ok.kmeans_plusplus_loop(xt, mask, torch.Generator().manual_seed(3), 8)
    assert torch.equal(got, want)
    assert torch.equal(kk.seed_plusplus(xt, None, torch.Generator().manual_seed(3), 5),
                       ok.kmeans_plusplus_init(xt, torch.ones(200), torch.Generator().manual_seed(3), 5))


@pytest.mark.parametrize("x, w, k, error", [
    (torch.zeros(10, 4, dtype=torch.float64), None, 3, TypeError),
    (torch.zeros(10, 65), None, 3, ValueError),
    (torch.zeros(10), None, 3, ValueError),
    (torch.zeros(10, 4), torch.ones(9), 3, ValueError),
    (torch.zeros(0, 4), None, 3, ValueError),
    (torch.zeros(40, 4), None, 2 ** 31, ValueError),
])
def test_the_wrapper_refuses_what_k5_does_not_take(x, w, k, error):
    with pytest.raises(error):
        kk.seed_plusplus(x, w, torch.Generator().manual_seed(0), k)


def test_the_cpu_route_counts_no_k5_launch():
    x, w = _planted()
    kk.reset_launches()
    kk.seed_plusplus(torch.from_numpy(x).float(), None, torch.Generator().manual_seed(3), 5)
    assert kk.launches["seed_select"] == kk.launches["seed_potentials"] == 0


@pytest.mark.parametrize("d, t, keeps", [(16, 9, True), (10, 9, False), (11, 9, True), (3, 5, False),
                                         (64, 32, True), (1, 1, False)])
def test_k5_keeps_the_distances_where_that_moves_fewer_bytes(d, t, keeps):
    assert kk.seed_keeps_d2(d, t) is keeps
