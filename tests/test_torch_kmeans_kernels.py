"""Kernels K2 and K3 on the CPU (their plain versions), the port's
``lloyd_fused`` and the feasibility rules, against the JAX package.

Inputs are numpy from a seed; the JAX side runs as its own tests run it
(the Pallas kernels in interpret mode, x64 on). Tolerances:

- one call of ``assign_stats_plain`` / ``assign_stats_packed_plain``
  against ``assign_stats_fused`` / ``assign_stats_packed(interpret=True)``
  after the reference's padding correction: counts identical, sums within
  1e-5 of max |sums|, cost 1e-5 relative. XLA:CPU computes every
  ``lax.Precision`` in full fp32, so the interpret kernels' "default" is
  fp32 there; "default" is therefore held on bf16-representable inputs,
  where rounding them again changes nothing. "high" runs on general
  inputs: the port rounds the low parts to bf16 as the TPU does (≤ 2^-18
  relative per product), the interpreter does not. The data sit near the
  origin so the cost's ``Σ‖x‖² + Σ min`` loses little to cancellation.
- the interpret output is trusted per call only (over a whole Lloyd run it
  is a known red, ROADMAP C): ``lloyd_fused`` is held against JAX
  ``lloyd`` from a pinned init, centers 1e-4 and cost 1e-4 relative, the
  bar of tests/test_kmeans_fused.py.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops.kmeans import lloyd as jax_lloyd
from spark_rapids_ml_tpu.ops.pallas import kmeans as jpk
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.ops.kernels import kmeans as kk
from spark_rapids_ml_tpu_torch.utils.testing import assert_close, kmeans_stats_f64

MODES = ("highest", "high", "default")


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _near_origin(n, d, k, seed, bf16=False):
    """Blobs near the origin (means 2 from it in random directions, unit
    noise) and centers jittered off the means, float32 (bf16-representable
    if asked)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(k, d))
    means *= 2.0 / np.linalg.norm(means, axis=1, keepdims=True)
    x = means[rng.integers(0, k, n)] + rng.normal(size=(n, d))
    c = means + 0.2 * rng.normal(size=(k, d))
    x, c = x.astype(np.float32), c.astype(np.float32)
    if bf16:
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        c = torch.from_numpy(c).to(torch.bfloat16).float().numpy()
    return x, c


def _jax_stats(fn, x, c, mode, block_n=256):
    """A reference kernel call on the padded transposed layout, with the
    reference's closed-form padding correction (pallas/kmeans.py:445-453)."""
    xt, n_true = jpk.pad_transposed(jnp.asarray(x), block_n=block_n)
    d_pad = xt.shape[0]
    cp = jnp.pad(jnp.asarray(c), ((0, 0), (0, d_pad - c.shape[1])))
    sums, counts, cost, c2 = fn(xt, cp, block_n=block_n, precision=mode, interpret=True)
    n_pad = xt.shape[1] - n_true
    pad_label = int(jnp.argmin(c2))
    counts = np.asarray(counts, dtype=np.float64)
    counts[pad_label] -= n_pad
    cost = float(cost) - n_pad * float(c2[pad_label])
    return np.asarray(sums)[:, : c.shape[1]], counts, cost, np.asarray(c2)


def _hold(name, got, want):
    sums, counts, cost, c2 = got
    wsums, wcounts, wcost, wc2 = want
    assert np.array_equal(counts.numpy().astype(np.float64), wcounts), name
    assert_close(f"{name} sums", sums, wsums, rtol=0, atol=1e-5 * np.abs(wsums).max())
    assert abs(float(cost) - wcost) <= 1e-5 * abs(wcost), (name, float(cost), wcost)
    assert_close(f"{name} c2", c2, wc2, rtol=1e-6)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,d,k", [(1100, 16, 6), (1100, 13, 8), (530, 13, 5)])
def test_k2_plain_matches_pallas_interpret(mode, n, d, k):
    x, c = _near_origin(n, d, k, seed=n + d + k, bf16=mode == "default")
    got = kk.assign_stats_fused(torch.from_numpy(x), torch.from_numpy(c), mode)
    assert got[1].dtype == torch.int64 and int(got[1].sum()) == n
    _hold(f"K2 plain {mode}", got, _jax_stats(jpk.assign_stats_fused, x, c, mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,d,k", [(1100, 16, 6), (1100, 13, 8), (777, 16, 16), (513, 8, 4)])
def test_k3_plain_matches_pallas_interpret(mode, n, d, k):
    assert kk.packed_feasible(d, k)
    x, c = _near_origin(n, d, k, seed=3 * n + d + k, bf16=mode == "default")
    got = kk.assign_stats_packed(torch.from_numpy(x), torch.from_numpy(c), mode)
    _hold(f"K3 plain {mode}", got, _jax_stats(jpk.assign_stats_packed, x, c, mode))


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_float64_statistics(mode):
    """The plain version against the float64 statistics of the same
    function (the on-card check of the kernels uses the same reference)."""
    x, c = _near_origin(2000, 16, 7, seed=41)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    sums, counts, cost, c2 = kk.assign_stats_plain(xt, ct, mode)
    rs, rc, rcost, _ = kmeans_stats_f64(xt, ct, mode, c2=c2)
    assert torch.equal(counts, rc)
    assert_close("sums vs f64", sums, rs, rtol=0, atol=1e-5 * float(rs.abs().max()))
    assert abs(float(cost) - float(rcost)) <= 1e-5 * float(rcost)


@pytest.mark.parametrize("policy,mode", [("f32", "highest"), ("bf16x3", "high"), ("bf16", "default")])
def test_policy_names_map_to_kernel_modes(policy, mode):
    from spark_rapids_ml_tpu.ops.precision import pallas_precision as jax_pallas_precision
    from spark_rapids_ml_tpu_torch.ops.precision import pallas_precision

    assert pallas_precision(policy) == mode == jax_pallas_precision(policy)
    assert pallas_precision(mode) == mode
    x, c = _near_origin(300, 16, 4, seed=5)
    a = kk.assign_stats_fused(torch.from_numpy(x), torch.from_numpy(c), policy)
    b = kk.assign_stats_fused(torch.from_numpy(x), torch.from_numpy(c), mode)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.fixture(scope="module")
def blob_data():
    """tests/test_kmeans_fused.py's data: 1100 x 16, six blobs 4 apart."""
    rng = np.random.default_rng(3)
    n, d, k = 1100, 16, 6
    x = (rng.normal(size=(n, d)) + rng.integers(0, k, n)[:, None] * 4).astype(np.float32)
    init = x[np.random.default_rng(11).choice(n, k, replace=False)]
    return x, init, k


#: The JAX ``lloyd`` mode each kernel mode is held against: XLA:CPU runs
#: "high"/"default" in full fp32, so the one-pass bf16 mode is held against
#: the reference's explicit "bf16" (operands cast to bf16), "high" against
#: fp32 (its 2^-18 low-part rounding stays inside the bar).
_JAX_LLOYD_MODE = {"highest": "highest", "high": "highest", "default": "bf16"}


@pytest.mark.parametrize("packed", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("mode", MODES)
def test_lloyd_fused_plain_route_matches_jax_lloyd(blob_data, packed, mode):
    x, init, k = blob_data
    centers, cost, n_iter = kk.lloyd_fused(
        torch.from_numpy(x), torch.from_numpy(init), max_iter=8, tol=0.0,
        precision=mode, packed=packed,
    )
    jc, jcost, jit = jax_lloyd(
        jnp.asarray(x), jnp.ones(x.shape[0], jnp.float32), jnp.asarray(init), max_iter=8, tol=0.0,
        precision=_JAX_LLOYD_MODE[mode],
    )
    assert n_iter == int(jit) == 8
    assert_close(f"lloyd_fused centers {mode}", centers, np.asarray(jc), rtol=0, atol=1e-4)
    assert float(cost) == pytest.approx(float(jcost), rel=1e-4)


def test_lloyd_fused_cosine_matches_jax_lloyd():
    from spark_rapids_ml_tpu.ops.kmeans import normalize_rows as jax_normalize_rows
    from spark_rapids_ml_tpu_torch.ops.kmeans import normalize_rows

    rng = np.random.default_rng(7)
    raw = rng.normal(size=(400, 16)).astype(np.float32)
    x = normalize_rows(torch.from_numpy(raw))
    init = x[:4].clone()
    centers, cost, _ = kk.lloyd_fused(x, init, max_iter=6, tol=0.0, cosine=True)
    xj = jax_normalize_rows(jnp.asarray(raw))
    jc, jcost, _ = jax_lloyd(xj, jnp.ones(400, jnp.float32), xj[:4], max_iter=6, tol=0.0, cosine=True)
    assert_close("cosine centers", centers, np.asarray(jc), rtol=0, atol=1e-4)
    assert float(cost) == pytest.approx(float(jcost), rel=1e-4)


def test_lloyd_fused_stops_on_the_movement_rule(blob_data):
    x, init, k = blob_data
    _, _, n_iter = kk.lloyd_fused(torch.from_numpy(x), torch.from_numpy(init), max_iter=50, tol=1e-4)
    _, _, jit = jax_lloyd(
        jnp.asarray(x), jnp.ones(x.shape[0], jnp.float32), jnp.asarray(init), max_iter=50, tol=1e-4
    )
    assert 1 <= n_iter == int(jit) < 50


@pytest.mark.parametrize(
    "d,k",
    [(8, 16), (16, 16), (64, 64), (128, 4), (16, 32), (64, 65), (65, 4), (13, 16), (17, 17),
     (32, 32), (33, 33), (1, 1), (24, 33)],
)
def test_packed_feasible_matches_jax(d, k):
    assert kk.packed_feasible(d, k) == jpk.packed_feasible(d, k)


def test_packed_feasible_boundaries():
    assert kk.packed_feasible(16, 16) and not kk.packed_feasible(16, 17)
    assert kk.packed_feasible(32, 32) and not kk.packed_feasible(32, 33)
    assert kk.packed_feasible(64, 64) and not kk.packed_feasible(64, 65)
    assert not kk.packed_feasible(65, 4)


def test_fused_feasible_is_the_shared_memory_rule():
    kmax = max(k for k in range(1, 2000) if kk.fused_feasible(16, k))
    assert 900 <= kmax < 1000
    assert kk.fused_shared_bytes(16, kmax) <= kk.MAX_SHARED_BYTES < kk.fused_shared_bytes(16, kmax + 1)
    assert kk.fused_feasible(16, 100) and kk.fused_feasible(64, 64) and kk.fused_feasible(13, 7)
    assert not kk.fused_feasible(1024, 100)  # the reference's VMEM rule admits this one
    assert jpk.fused_feasible(1024, 100)
    assert not kk.fused_feasible(0, 4) and not kk.fused_feasible(4, 0)


def test_launches_stay_zero_on_cpu():
    kk.reset_launches()
    x, c = _near_origin(50, 16, 3, seed=1)
    kk.assign_stats_fused(torch.from_numpy(x), torch.from_numpy(c))
    kk.assign_stats_packed(torch.from_numpy(x), torch.from_numpy(c))
    kk.lloyd_fused(torch.from_numpy(x), torch.from_numpy(c), max_iter=2)
    kk.seed_plusplus(torch.from_numpy(x), None, torch.Generator().manual_seed(0), 3)
    assert kk.launches == {"assign_stats_fused": 0, "assign_stats_packed": 0, "seed_select": 0,
                           "seed_potentials": 0}


def test_wrappers_validate_their_inputs():
    x = torch.from_numpy(_near_origin(16, 4, 2, seed=2)[0])
    c = x[:2].clone()
    for assign in (kk.assign_stats_fused, kk.assign_stats_packed):
        with pytest.raises(ValueError, match="2-D"):
            assign(x[0], c)
        with pytest.raises(ValueError, match="width"):
            assign(x, c[:, :3].contiguous())
        with pytest.raises(TypeError, match="float32"):
            assign(x.double(), c.double())
        with pytest.raises(ValueError, match="contiguous"):
            assign(torch.zeros((4, 16)).T, c)
        with pytest.raises(ValueError, match="precision"):
            assign(x, c, "fp8")
        with pytest.raises(ValueError, match="k >= 1"):
            assign(x, c[:0])
        with pytest.raises(ValueError, match="runs on CUDA or CPU"):
            assign(x.to("meta"), c.to("meta"))
    with pytest.raises(ValueError, match="packing infeasible"):
        kk.assign_stats_packed(x, torch.zeros((17, 4)))


def test_empty_rows_give_zero_statistics():
    c = torch.from_numpy(_near_origin(10, 5, 3, seed=4)[1])
    sums, counts, cost, c2 = kk.assign_stats_fused(torch.zeros((0, 5)), c)
    assert torch.equal(sums, torch.zeros((3, 5))) and torch.equal(counts, torch.zeros(3, dtype=torch.int64))
    assert float(cost) == 0.0
    assert_close("c2", c2, (c.double() ** 2).sum(dim=1), rtol=1e-6)


def test_plain_ties_go_to_the_lowest_index():
    x, c = _near_origin(500, 8, 4, seed=9)
    dup = torch.from_numpy(np.concatenate([c, c]))
    counts = kk.assign_stats_fused(torch.from_numpy(x), dup)[1]
    assert int(counts[4:].sum()) == 0 and int(counts.sum()) == 500


def test_k3_geometry_matches_the_source():
    """The wrapper's K3 warps per block are the source's WARPS_16/32/64."""
    text = (Path(kk.__file__).resolve().parents[2] / "csrc" / f"{kk.PACKED_NAME}.cu").read_text()
    cu = {int(m[0]): int(m[1]) for m in re.findall(r"constexpr int WARPS_(\d+) = (\d+);", text)}
    assert cu == kk.PACKED_WARPS
    assert {dg: kk.packed_threads(dg) for dg in cu} == {dg: 32 * w for dg, w in cu.items()}


@pytest.mark.parametrize(
    "n,dg,sms,per_sm,want",
    [
        (20_000_000, 16, 132, 1, 132),  # one wave on a full card
        (20_000_000, 64, 132, 2, 264),
        ("2T-1", 16, 132, 1, 2),  # no more than one block per block of threads
        ("2T-1", 32, 132, 4, 2),
        (1, 32, 132, 1, 1),
        (0, 16, 132, 1, 1),  # at least one block
    ],
)
def test_k3_block_plan_is_one_wave(n, dg, sms, per_sm, want):
    if n == "2T-1":
        n = 2 * kk.packed_threads(dg) - 1
    assert kk.packed_blocks(n, dg, sms, per_sm) == want


# --- K2's two variants and its block plan ---------------------------------


def _k2_source_constants():
    text = (Path(kk.__file__).resolve().parents[2] / "csrc" / f"{kk.FUSED_NAME}.cu").read_text()
    ints = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    ints["MAX_SMEM"] = int(re.search(r"constexpr size_t MAX_SMEM = (\d+);", text)[1])
    return ints


def test_k2_geometry_matches_the_source():
    """The wrapper's K2 constants are the source's: the sort variant's
    block, the warp variant's rows a lane, warp caps and the cost's bytes."""
    cu = _k2_source_constants()
    assert cu["BLOCK"] == kk.FUSED_THREADS and cu["BLOCK"] // 32 == kk.FUSED_WARPS
    assert cu["MAX_SMEM"] == kk.MAX_SHARED_BYTES
    assert {w: cu[f"ROWS_{w}"] for w in (16, 32, 64)} == kk.FUSED_ROWS
    assert {w: cu.get(f"ROWS_{w}_HIGH", cu[f"ROWS_{w}"]) for w in (16, 32, 64)} == kk.FUSED_ROWS_HIGH
    assert (cu["WARPS_MAX"], cu["WARPS_MAX_WIDE"], cu["WARPS_MIN"], cu["RED_BYTES"]) == (
        kk.FUSED_WARPS_MAX, kk.FUSED_WARPS_MAX_WIDE, kk.FUSED_WARPS_MIN, kk.FUSED_RED_BYTES)


@pytest.mark.parametrize(
    "d,k,mode,want",
    [
        (16, 100, "highest", 12),  # the main path: 20M x 16, k = 100
        (16, 100, "default", 12),
        (16, 100, "high", 12),
        (16, 546, "highest", 4),  # the last k of the warp variant at width 16
        (16, 547, "highest", 0),  # the first of the sort variant
        (13, 546, "default", 4),
        (16, 511, "high", 4),
        (16, 512, "high", 0),
        (32, 100, "highest", 8),
        (64, 137, "highest", 4),
        (64, 138, "highest", 0),
        (64, 1, "high", 8),  # 128 row registers a lane: the wide cap
        (65, 4, "highest", 0),  # past width 64: the sort variant
        (1024, 18, "highest", 0),
    ],
)
def test_k2_variant_choice(d, k, mode, want):
    assert kk.fused_warps(d, k, mode) == want


@pytest.mark.parametrize("mode", MODES)
def test_k2_warp_variant_fills_its_shared_memory(mode):
    """Where the warp variant runs, its warps are a multiple of 4 between
    WARPS_MIN and the cap, fit the block's shared memory, and 4 more would
    pass the cap or not fit."""
    for d in (1, 5, 13, 16, 17, 24, 32, 40, 64):
        dreg = kk._register_width(d)
        cap = (kk.FUSED_WARPS_MAX_WIDE
               if kk.fused_rows(dreg, mode) * dreg * (2 if mode == "high" else 1) >= 128
               else kk.FUSED_WARPS_MAX)
        for k in (1, 2, 7, 31, 100, 137, 300, 546, 800):
            w = kk.fused_warps(d, k, mode)
            if w == 0:
                assert (kk.fused_warp_shared_bytes(d, k, mode, kk.FUSED_WARPS_MIN)
                        > kk.MAX_SHARED_BYTES), (d, k)
                continue
            assert w % 4 == 0 and kk.FUSED_WARPS_MIN <= w <= cap, (d, k, w)
            assert kk.fused_warp_shared_bytes(d, k, mode, w) <= kk.MAX_SHARED_BYTES
            assert w == cap or kk.fused_warp_shared_bytes(d, k, mode, w + 4) > kk.MAX_SHARED_BYTES


def test_k2_block_unit_is_a_round_of_subtiles():
    assert kk.fused_unit(16, 100, "highest") == 32 * 4 * 12
    assert kk.fused_unit(16, 100, "high") == 32 * 2 * 12
    assert kk.fused_unit(64, 100, "highest") == 32 * 1 * 4
    assert kk.fused_unit(16, 900, "highest") == kk.FUSED_THREADS  # the sort variant's tile
    assert kk.fused_unit(100, 7, "highest") == kk.FUSED_THREADS


@pytest.mark.parametrize(
    "n,unit,kd,sms,per_sm,want",
    [
        (20_000_000, 1536, 1600, 132, 1, 132),  # one wave on a full card
        (20_000_000, 256, 1600, 132, 3, 396),
        (2 * 1536 - 1, 1536, 1600, 132, 1, 2),  # no more than one block per unit of rows
        (1, 1536, 1600, 132, 1, 1),
        (0, 1536, 1600, 132, 1, 1),  # at least one block
        (20_000_000, 256, 1 << 24, 132, 4, (256 << 20) // (4 << 24)),  # the workspace cap
    ],
)
def test_k2_block_plan_is_one_wave(n, unit, kd, sms, per_sm, want):
    assert kk.fused_blocks(n, unit, kd, sms, per_sm) == want


@pytest.mark.parametrize("d,limit", [(16, 971), (32, 535), (64, 282), (128, 145), (1024, 18)])
def test_fused_feasible_keeps_its_limits(d, limit):
    """The largest k K2 takes at each width, frozen: a redesign of the
    kernel keeps every shape it took before."""
    assert kk.fused_feasible(d, limit) and not kk.fused_feasible(d, limit + 1)


@pytest.mark.parametrize("mode", MODES)
def test_k2_plain_matches_pallas_interpret_on_sorted_labels(mode):
    """Rows ordered by their labels (each run of a warp's rows shares one
    label, as in a table sorted by cluster)."""
    x, c = _near_origin(1100, 16, 6, seed=77, bf16=mode == "default")
    labels = kmeans_stats_f64(torch.from_numpy(x), torch.from_numpy(c), mode)[3]
    x = np.ascontiguousarray(x[np.argsort(labels.numpy(), kind="stable")])
    got = kk.assign_stats_fused(torch.from_numpy(x), torch.from_numpy(c), mode)
    _hold(f"K2 plain sorted {mode}", got, _jax_stats(jpk.assign_stats_fused, x, c, mode))
