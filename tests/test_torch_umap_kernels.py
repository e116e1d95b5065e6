"""Kernel K4 (``tail_accumulate``) on the CPU, its plan and its routing
rule, against the JAX package's Pallas kernel.

The JAX side runs as its own tests run it (``interpret=True``). The port
takes the kernel's plain version on a CPU tensor. Tolerance: atol 1e-4,
rtol 1e-5, the bar of ``tests/test_umap.py``'s tail test (the Pallas
kernel sums per tile in its own order). The plan's ``perm`` equals the
reference's element for element; ``plan_feasible`` agrees on both sides
of its boundaries.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops.pallas import umap as jpu
from spark_rapids_ml_tpu_torch.ops.kernels import umap as k4

SHAPES = [(600, 8, 2), (257, 5, 3), (1024, 15, 2), (130, 3, 10)]


def _edges(n, k, dim, seed):
    rng = np.random.default_rng(seed)
    indices = rng.integers(0, n, size=(n, k))
    g = rng.normal(size=(n * k, dim)).astype(np.float32)
    return indices, g


@pytest.mark.parametrize("n,k,dim", SHAPES)
def test_plain_version_matches_the_pallas_kernel(n, k, dim):
    indices, g = _edges(n, k, dim, seed=n + k + dim)
    jplan, jcfg = jpu.build_tail_plan(indices, n, dim)
    want = np.asarray(jpu.tail_accumulate(jnp.asarray(g), jplan, jcfg, interpret=True))
    plan = k4.build_tail_plan(torch.from_numpy(indices), n, dim)
    before = k4.launches["tail_accumulate"]
    got = k4.tail_accumulate(torch.from_numpy(g), plan)
    assert k4.launches["tail_accumulate"] == before  # the CPU route launches nothing
    assert got.shape == (n, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    exact = np.zeros((n, dim))
    np.add.at(exact, indices.reshape(-1), g.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("n,k,dim", SHAPES)
def test_plan_matches_the_reference_plan(n, k, dim):
    indices, _ = _edges(n, k, dim, seed=7 * n + k)
    jplan, jcfg = jpu.build_tail_plan(indices, n, dim)
    plan = k4.build_tail_plan(torch.from_numpy(indices), n, dim)
    assert plan.perm.dtype == torch.int32 and plan.offsets.dtype == torch.int32
    assert np.array_equal(plan.perm.numpy(), np.asarray(jplan.perm))
    tails_sorted = indices.reshape(-1)[plan.perm.numpy()]
    assert np.array_equal(plan.tails.numpy(), tails_sorted)
    # CSR: row t's edges are perm[offsets[t]:offsets[t + 1]].
    want_offsets = np.searchsorted(tails_sorted, np.arange(n + 1), side="left")
    assert np.array_equal(plan.offsets.numpy(), want_offsets)
    assert plan.offsets[-1].item() == n * k == jcfg.e


@pytest.mark.parametrize(
    "n,k,dim",
    [(1000, 15, 128), (1000, 15, 129), (0, 15, 2), (5, 0, 2), (1, 1, 1), (50_000, 15, 2), (10, 3, 64)],
)
def test_plan_feasible_agrees_with_the_reference(n, k, dim):
    assert k4.plan_feasible(n, k, dim) == jpu.plan_feasible(n, k, dim)


def test_hub_and_empty_rows():
    n, k, dim = 200, 6, 2
    indices = np.full((n, k), 17)
    indices[::2, 0] = 150  # rows other than 17 and 150 get no edges
    g = np.random.default_rng(3).normal(size=(n * k, dim)).astype(np.float32)
    plan = k4.build_tail_plan(torch.from_numpy(indices), n, dim)
    out = k4.tail_accumulate(torch.from_numpy(g), plan).numpy()
    exact = np.zeros((n, dim))
    np.add.at(exact, indices.reshape(-1), g.astype(np.float64))
    np.testing.assert_allclose(out, exact, atol=1e-4, rtol=1e-5)
    assert np.count_nonzero(np.delete(out, [17, 150], axis=0)) == 0


def _degree_pattern(name: str):
    """Tails that drive each path of the kernel: every row's run short
    (the grouped path), one hub of 32·U + 1 edges (the whole warp, more
    than one round), and a warp's group of rows mixing empty, short and
    long runs."""
    u = k4.EDGES_PER_LANE
    if name == "all_short":
        n, k = 258, 4
        indices = (np.arange(n)[:, None] + 37 * np.arange(k)[None, :]) % n  # in-degree k each
    elif name == "hub":
        n, k = 300, 2
        indices = np.random.default_rng(5).integers(0, n, size=(n, k))
        indices.reshape(-1)[: 32 * u + 1] = 5
    else:
        n, k = 66, 3
        indices = np.random.default_rng(6).integers(8, n, size=(n, k))
        flat = indices.reshape(-1)
        flat[:100] = 4                  # rows 4..7 share a warp: 4 long,
        flat[100:103] = 7               # 7 short, 5 and 6 empty
    return n, k, indices


@pytest.mark.parametrize("pattern", ["all_short", "hub", "mixed_group"])
@pytest.mark.parametrize("dim", [1, 2, 5])
def test_plain_version_matches_the_pallas_kernel_at_degree_patterns(pattern, dim):
    n, k, indices = _degree_pattern(pattern)
    indeg = np.bincount(indices.reshape(-1), minlength=n)
    if pattern == "all_short":
        assert indeg.max() <= k4.SHORT_RUN
    elif pattern == "hub":
        assert indeg.max() > 32 * k4.EDGES_PER_LANE
    else:
        assert indeg[4] > k4.SHORT_RUN and indeg[5] == indeg[6] == 0 and 0 < indeg[7] <= k4.SHORT_RUN
    g = np.random.default_rng(n + dim).normal(size=(n * k, dim)).astype(np.float32)
    jplan, jcfg = jpu.build_tail_plan(indices, n, dim)
    want = np.asarray(jpu.tail_accumulate(jnp.asarray(g), jplan, jcfg, interpret=True))
    got = k4.tail_accumulate(torch.from_numpy(g), k4.build_tail_plan(torch.from_numpy(indices), n, dim))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    assert np.count_nonzero(got.numpy()[indeg == 0]) == 0


def test_k4_geometry_matches_the_source():
    text = (Path(k4.__file__).resolve().parents[2] / "csrc" / f"{k4.NAME}.cu").read_text()
    cu = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert (k4.WARPS, k4.ROWS_PER_WARP, k4.EDGES_PER_LANE) == (cu["WARPS"], cu["ROWS_PER_WARP"], cu["UNROLL"])
    assert k4.SHORT_RUN == 32 // cu["ROWS_PER_WARP"] * cu["UNROLL"]


@pytest.mark.parametrize(
    "bad,error,match",
    [
        (lambda g: g.double(), TypeError, "float32"),
        (lambda g: g[:-1], ValueError, "!= plan"),
        (lambda g: torch.zeros((g.shape[1], g.shape[0])).T, ValueError, "contiguous"),
        (lambda g: g.reshape(-1), ValueError, "!= plan"),
    ],
)
def test_wrapper_refusals(bad, error, match):
    indices, g = _edges(50, 4, 2, seed=1)
    plan = k4.build_tail_plan(torch.from_numpy(indices), 50, 2)
    with pytest.raises(error, match=match):
        k4.tail_accumulate(bad(torch.from_numpy(g)), plan)
