"""The port's forest ops (``ops/trees.py``) against the JAX package's
``ops/trees.py``, on the same numpy inputs, with JAX's edges, bootstrap
weights and feature-subset draws passed in.

Tolerances: quantile edges, bins, integer histograms, split decisions,
classification forests (gini) and their predictions are held bitwise.
Entropy uses log2, whose float32 result differs between XLA:CPU and torch
in the last bit: its impurities and ``node_impurity`` are held to 1e-6
relative, its ``node_gain`` (a difference of O(1) entropies) to 1e-6
absolute, every other field bitwise. Real-valued (regression and
weighted) histograms and node weights are summed in another order than
XLA's: 1e-6 relative; regression trees have the same structure and
leaves within 1e-5. Feature importances of one forest: 1e-12.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops import trees as jt
from spark_rapids_ml_tpu_torch.ops import trees as pt
from spark_rapids_ml_tpu_torch.utils.testing import assert_close

FIELDS = pt.Forest._fields


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _bits_equal(a, b) -> bool:
    a, b = np.ascontiguousarray(_np(a)), np.ascontiguousarray(_np(b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _features(n, d, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((n, d)) * scale).astype(np.float32)


# --- _fma ------------------------------------------------------------------


def _round_once(a, b, c) -> np.float32:
    """a·b + c rounded once to float32, in exact rational arithmetic."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(exact))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    errs = [abs(Fraction(float(v)) - exact) for v in cands]
    best = [v for v, e in zip(cands, errs) if e == min(errs)]
    return best[0] if len(best) == 1 else [v for v in best if np.array(v).view(np.int32) % 2 == 0][0]


@pytest.mark.parametrize("seed", range(3))
def test_fma_rounds_once(seed):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(300) * 10 ** rng.uniform(-3, 3, 300)).astype(np.float32)
    b = rng.uniform(0, 1, 300).astype(np.float32)
    c = (rng.standard_normal(300) * 10 ** rng.uniform(-3, 3, 300)).astype(np.float32)
    got = pt._fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([_round_once(*v) for v in zip(a, b, c)], dtype=np.float32)
    assert _bits_equal(got, want)


def test_fma_settles_a_float64_sum_halfway_between_two_floats():
    # a·b = 2^-24 − 2^-70 and c = 1 + 2^-23: the float64 sum rounds to
    # 1 + 3·2^-24, halfway between two float32 values, where ties-to-even
    # would round up; the exact sum lies below it, so once-rounded is c.
    a = torch.tensor([2.0 ** -12 * (1 + 2.0 ** -23)], dtype=torch.float32)
    b = torch.tensor([2.0 ** -12 * (1 - 2.0 ** -23)], dtype=torch.float32)
    c = torch.tensor([1 + 2.0 ** -23], dtype=torch.float32)
    twice = (a.double() * b.double() + c.double()).float()
    assert twice.item() == 1 + 2.0 ** -22
    got = pt._fma(a, b, c)
    assert got.item() == 1 + 2.0 ** -23 == _round_once(a.item(), b.item(), c.item())
    assert pt._fma(-a, b, -c).item() == -(1 + 2.0 ** -23)


# --- quantize and bin ------------------------------------------------------


@pytest.mark.parametrize("n,d,bins", [(50, 2, 2), (700, 5, 16), (1500, 7, 32), (999, 3, 64), (2000, 16, 17)])
def test_quantize_features_is_bitwise_the_reference(n, d, bins):
    x = _features(n, d, seed=n + d)
    want = np.asarray(jt.quantize_features(jnp.asarray(x), bins))
    got = pt.quantize_features(torch.from_numpy(x), bins)
    assert got.shape == (d, bins - 1) and _bits_equal(got, want)


@pytest.mark.parametrize("max_sample_rows", [97, 500])
def test_quantize_features_strides_above_the_sample_cap(max_sample_rows):
    x = _features(1800, 4, seed=7)
    want = np.asarray(jt.quantize_features(jnp.asarray(x), 16, max_sample_rows))
    assert _bits_equal(pt.quantize_features(torch.from_numpy(x), 16, max_sample_rows), want)


def test_quantize_features_where_torch_quantile_differs():
    x = _features(1501, 6, seed=11, scale=50.0)
    want = np.asarray(jt.quantize_features(jnp.asarray(x), 32))
    q = torch.arange(1, 32, dtype=torch.float32) / 32
    library = torch.quantile(torch.from_numpy(x), q, dim=0).T.numpy()
    assert np.mean(library != want) >= 0.10  # the case this port guards against
    assert _bits_equal(pt.quantize_features(torch.from_numpy(x), 32), want)


def test_quantize_features_nan_column():
    x = _features(300, 3, seed=2)
    x[17, 1] = np.nan
    want = np.asarray(jt.quantize_features(jnp.asarray(x), 8))
    got = pt.quantize_features(torch.from_numpy(x), 8).numpy()
    assert np.all(np.isnan(got[1])) and np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("bins", [2, 16, 33])
def test_bin_features_matches_the_reference(bins):
    x = _features(1200, 5, seed=bins)
    x[:40, 2] = 0.5  # a tied column
    edges = jt.quantize_features(jnp.asarray(x), bins)
    want = np.asarray(jt.bin_features(jnp.asarray(x), edges))
    got = pt.bin_features(torch.from_numpy(x), torch.from_numpy(np.asarray(edges)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


# --- impurity, histograms, split ------------------------------------------


def _class_hist(shape, seed):
    return np.random.default_rng(seed).integers(0, 30, shape).astype(np.float32)


def _reg_hist(shape, seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 5, shape[:-1] + (1,)).astype(np.float32)
    y = rng.standard_normal(shape[:-1] + (1,)).astype(np.float32)
    return np.concatenate([c, c * y, c * y * y], -1).astype(np.float32)


@pytest.mark.parametrize("kind,S", [("gini", 2), ("gini", 3), ("gini", 5), ("entropy", 2), ("entropy", 3),
                                    ("variance", 3)])
def test_impurity_matches_the_reference(kind, S):
    stats = _reg_hist((6, 4, 9, 3), S) if kind == "variance" else _class_hist((6, 4, 9, S), S)
    stats[0, 0] = 0.0  # empty nodes
    want_imp, want_w = jax.jit(jt._impurity, static_argnums=1)(jnp.asarray(stats), kind)
    got_imp, got_w = pt._impurity(torch.from_numpy(stats), kind)
    assert _bits_equal(got_w, want_w)
    if kind == "entropy":
        assert_close(f"{kind} impurity", got_imp, want_imp, rtol=1e-6, atol=1e-7)
    else:
        assert _bits_equal(got_imp, want_imp)


def test_unknown_impurity_raises_as_the_reference():
    with pytest.raises(ValueError, match="unknown impurity 'mse'"):
        pt._impurity(torch.ones((2, 3)), "mse")


def _routing(T, n, depth_level, seed):
    rng = np.random.default_rng(seed)
    offset = 2 ** depth_level - 1
    node_idx = rng.integers(offset - 1, offset + 2 ** depth_level + 1, (T, n)).astype(np.int32)
    node_idx[:, :5] = -1
    return node_idx, offset


@pytest.mark.parametrize("block_rows", [64, 4096])
@pytest.mark.parametrize("level", [0, 2])
@pytest.mark.parametrize("stats_kind", ["counts", "weighted", "regression"])
def test_level_histogram_and_totals_match_the_reference(stats_kind, level, block_rows):
    T, n, d, B = 3, 700, 4, 8
    rng = np.random.default_rng(level)
    node_idx, offset = _routing(T, n, level, seed=level)
    xb = rng.integers(0, B, (n, d)).astype(np.int32)
    if stats_kind == "counts":
        rs = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
        w = rng.poisson(1.0, (T, n)).astype(np.float32)
    elif stats_kind == "weighted":
        rs = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)] * rng.uniform(0.1, 2, (n, 1)).astype(np.float32)
        w = rng.poisson(1.0, (T, n)).astype(np.float32)
    else:
        y = rng.standard_normal(n).astype(np.float32)
        rs = np.stack([np.ones_like(y), y, y * y], 1)
        w = rng.uniform(0, 2, (T, n)).astype(np.float32)
    m = 2 ** level
    prec = "default" if stats_kind == "counts" else "highest"
    jprec = jax.lax.Precision.DEFAULT if stats_kind == "counts" else jax.lax.Precision.HIGHEST
    want_h = np.asarray(jt._level_histogram(jnp.asarray(node_idx), jnp.asarray(w), jnp.asarray(xb), jnp.asarray(rs),
                                            offset, m, B, block_rows, jprec))
    want_t = np.asarray(jt._node_totals(jnp.asarray(node_idx), jnp.asarray(w), jnp.asarray(rs), offset, m,
                                        block_rows, jprec))
    args = (torch.from_numpy(node_idx), torch.from_numpy(w))
    got_h = pt._level_histogram(*args, torch.from_numpy(xb), torch.from_numpy(rs), offset, m, B, block_rows, prec)
    got_t = pt._node_totals(*args, torch.from_numpy(rs), offset, m, block_rows, prec)
    assert got_h.shape == want_h.shape and got_h.dtype == torch.float32
    if stats_kind == "counts":
        assert _bits_equal(got_h, want_h) and _bits_equal(got_t, want_t)
    else:
        assert_close("histogram", got_h, want_h, rtol=1e-6, atol=1e-6 * np.abs(want_h).max())
        assert_close("totals", got_t, want_t, rtol=1e-6, atol=1e-6 * np.abs(want_t).max())
    got64 = pt._level_histogram(*args, torch.from_numpy(xb), torch.from_numpy(rs), offset, m, B, block_rows,
                                "float64")
    assert got64.dtype == torch.float32
    assert_close("float64 histogram", got64, want_h, rtol=1e-6, atol=1e-6 * np.abs(want_h).max())


SPLITS = [
    ("gini", 2, 5, 1, 0.0), ("gini", 3, 3, 1, 0.0), ("gini", 2, 2, 20, 0.0), ("gini", 2, 5, 1, 0.05),
    ("entropy", 2, 5, 1, 0.0), ("entropy", 3, 2, 3, 0.0), ("entropy", 2, 4, 1, 0.1),
    ("variance", 3, 5, 1, 0.0), ("variance", 3, 2, 4, 0.0), ("variance", 3, 3, 1, 0.02),
]


@pytest.mark.parametrize("kind,S,feat_subset,min_instances,min_info_gain", SPLITS)
@pytest.mark.parametrize("seed", range(2))
def test_split_level_with_the_reference_draws(kind, S, feat_subset, min_instances, min_info_gain, seed):
    T, M, d, B = 4, 4, 5, 12
    hist = _reg_hist((T, M, d, B, S), seed) if kind == "variance" else _class_hist((T, M, d, B, S), seed)
    key, level = jax.random.key(seed), 2
    want = jt.split_level(jnp.asarray(hist), key, level, impurity=kind, feat_subset=feat_subset,
                          min_instances=min_instances, min_info_gain=min_info_gain)
    u = torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, level), (T, M, d))))
    got = pt.split_level(torch.from_numpy(hist), u, impurity=kind, feat_subset=feat_subset,
                         min_instances=min_instances, min_info_gain=min_info_gain)
    best_f, best_b, best_gain, split_ok, total, w_parent = got
    assert best_f.dtype == best_b.dtype == torch.int32
    for name, g, w in (("best_f", best_f, want[0]), ("best_b", best_b, want[1]), ("split_ok", split_ok, want[3])):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert np.array_equal(w_parent.numpy()[split_ok.numpy()], np.asarray(want[5])[split_ok.numpy()])
    if kind == "gini":
        assert _bits_equal(best_gain, want[2]) and _bits_equal(total, want[4])
    else:
        ok = split_ok.numpy()
        assert_close("best gain", best_gain.numpy()[ok], np.asarray(want[2])[ok], rtol=1e-5, atol=1e-6)


# --- growth ----------------------------------------------------------------


def _draws(key, T, n, d, depth, rate=1.0, bootstrap=True):
    k_sample, k_feat = jax.random.split(key)
    w = np.asarray(jt.sample_weights(k_sample, T, n, rate, bootstrap))
    uniforms = [torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(k_feat, level), (T, 2 ** level, d))))
                for level in range(depth)]
    return w, k_feat, uniforms


def _task(kind, n=900, d=6, seed=1, weighted=False):
    x = _features(n, d, seed=seed, scale=1.0)
    rng = np.random.default_rng(seed)
    if kind == "variance":
        y = (2 * x[:, 0] + np.sin(3 * x[:, 1]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
        yc = y - y.mean()
        rs = np.stack([np.ones_like(yc), yc, yc * yc], 1).astype(np.float32)
    else:
        y = ((x[:, 0] + x[:, 1] * x[:, 2]) > 0).astype(int) + (x[:, 3] > 1)
        rs = np.eye(3, dtype=np.float32)[y]
    if weighted:
        rs = rs * rng.uniform(0.2, 3.0, (n, 1)).astype(np.float32)
    return x, rs


def _grow_both(kind, *, T=5, depth=4, B=16, feat_subset=3, min_instances=1, min_info_gain=0.0,
               weighted=False, block_rows=256, exact_counts=True, seed=1):
    x, rs = _task(kind, seed=seed, weighted=weighted)
    n, d = x.shape
    w, k_feat, uniforms = _draws(jax.random.key(seed), T, n, d, depth)
    edges = jt.quantize_features(jnp.asarray(x), B)
    xb = jt.bin_features(jnp.asarray(x), edges)
    kw = dict(max_depth=depth, n_bins=B, impurity=kind, feat_subset=feat_subset, min_instances=min_instances,
              min_info_gain=min_info_gain, block_rows=block_rows, exact_counts=exact_counts)
    want = jt.grow_forest(xb, jnp.asarray(rs), jnp.asarray(w), edges.astype(jnp.float32), k_feat, **kw)
    got = pt.grow_forest(torch.from_numpy(np.asarray(xb)), torch.from_numpy(rs), torch.from_numpy(w),
                         torch.from_numpy(np.asarray(edges)), uniforms, **kw)
    return x, want, got


def _hold_structure(want, got, weighted=False):
    for f in ("feature", "threshold", "is_leaf"):
        assert _bits_equal(getattr(got, f), getattr(want, f)), f
    if weighted:  # fractional weights: float32 sums in another order
        assert_close("node_weight", got.node_weight, want.node_weight, rtol=1e-6, atol=1e-6)
    else:
        assert _bits_equal(got.node_weight, want.node_weight)


GROW = {
    "gini": dict(kind="gini"),
    "gini_all_features": dict(kind="gini", feat_subset=6),
    "gini_depth_6": dict(kind="gini", depth=6, feat_subset=2),
    "gini_min_instances": dict(kind="gini", min_instances=25),
    "gini_min_info_gain": dict(kind="gini", min_info_gain=0.02),
    "gini_weighted": dict(kind="gini", weighted=True, exact_counts=False),
    "gini_ragged_blocks": dict(kind="gini", block_rows=97),
    "gini_depth_0": dict(kind="gini", depth=0),
    "gini_two_bins": dict(kind="gini", B=2),
}


@pytest.mark.parametrize("case", list(GROW))
def test_grow_forest_gini_is_bitwise_the_reference(case):
    _, want, got = _grow_both(**GROW[case])
    for f in FIELDS:
        if case == "gini_weighted" and f in ("leaf_value", "node_weight", "node_gain", "node_impurity"):
            # Fractional stats: float32 sums in another order than XLA's.
            assert_close(f, getattr(got, f), getattr(want, f), rtol=1e-5, atol=1e-6)
        else:
            assert _bits_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("case", [dict(), dict(feat_subset=6), dict(min_instances=10), dict(min_info_gain=0.05)])
def test_grow_forest_entropy_matches_the_reference(case):
    _, want, got = _grow_both("entropy", **case)
    for f in ("feature", "threshold", "is_leaf", "leaf_value", "node_weight"):
        assert _bits_equal(getattr(got, f), getattr(want, f)), f
    # A gain is a difference of O(1) entropies: its error is absolute.
    assert_close("node_gain", got.node_gain, want.node_gain, rtol=1e-6, atol=1e-6)
    assert_close("node_impurity", got.node_impurity, want.node_impurity, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", [dict(), dict(feat_subset=6, depth=5), dict(min_instances=30),
                                  dict(weighted=True)])
def test_grow_forest_regression_matches_the_reference(case):
    _, want, got = _grow_both("variance", **case)
    _hold_structure(want, got, weighted=case.get("weighted", False))
    assert_close("leaf_value", got.leaf_value, want.leaf_value, rtol=1e-5, atol=1e-5)
    assert_close("node_gain", got.node_gain, want.node_gain, rtol=1e-4, atol=1e-5)


def test_grow_forest_float64_histograms_give_the_same_classification_forest():
    x, rs = _task("gini")
    n, d = x.shape
    gen = torch.Generator().manual_seed(3)
    w = pt.sample_weights(gen, 4, n, 1.0, True)
    uniforms = [torch.rand((4, 2 ** level, d), generator=gen) for level in range(4)]
    edges = pt.quantize_features(torch.from_numpy(x), 16)
    xb = pt.bin_features(torch.from_numpy(x), edges)
    kw = dict(max_depth=4, n_bins=16, impurity="gini", feat_subset=3)
    a = pt.grow_forest(xb, torch.from_numpy(rs), w, edges, uniforms, **kw)
    b = pt.grow_forest(xb, torch.from_numpy(rs), w, edges, uniforms, hist_precision="float64", **kw)
    for f in FIELDS:
        assert _bits_equal(getattr(a, f), getattr(b, f)), f


def test_grow_forest_draws_from_the_generator_when_no_uniforms_are_given():
    x, rs = _task("gini")
    n, d = x.shape
    edges = pt.quantize_features(torch.from_numpy(x), 16)
    xb = pt.bin_features(torch.from_numpy(x), edges)
    w = torch.ones((3, n))
    kw = dict(max_depth=3, n_bins=16, impurity="gini", feat_subset=2)
    gen = torch.Generator().manual_seed(8)
    drawn = pt.grow_forest(xb, torch.from_numpy(rs), w, edges, generator=gen, **kw)
    gen = torch.Generator().manual_seed(8)
    uniforms = [torch.rand((3, 2 ** level, d), generator=gen) for level in range(3)]
    passed = pt.grow_forest(xb, torch.from_numpy(rs), w, edges, uniforms, **kw)
    for f in FIELDS:
        assert _bits_equal(getattr(drawn, f), getattr(passed, f)), f
    with pytest.raises(ValueError, match="uniforms or a generator"):
        pt.grow_forest(xb, torch.from_numpy(rs), w, edges, **kw)


@pytest.mark.parametrize("kind", ["gini", "variance"])
def test_fit_forest_fused_matches_the_reference(kind):
    x, rs = _task(kind)
    n, d = x.shape
    w, k_feat, uniforms = _draws(jax.random.key(4), 4, n, d, 4)
    kw = dict(max_depth=4, n_bins=16, impurity=kind, feat_subset=3)
    want = jt.fit_forest_fused(jnp.asarray(x), jnp.asarray(rs), jnp.asarray(w), k_feat, **kw)
    got = pt.fit_forest_fused(torch.from_numpy(x), torch.from_numpy(rs), torch.from_numpy(w), uniforms, **kw)
    for f in ("feature", "is_leaf", "node_weight"):
        assert _bits_equal(getattr(got, f), getattr(want, f)), f
    # In one XLA program the reference recomputes an edge for the threshold
    # gather with its own rounding: within one float32 ulp of the binning edge.
    assert np.all(np.abs(got.threshold.numpy() - np.asarray(want.threshold))
                  <= np.spacing(np.abs(np.asarray(want.threshold))))
    tol = 0.0 if kind == "gini" else 1e-5
    assert_close("leaf_value", got.leaf_value, want.leaf_value, rtol=tol, atol=tol)


def test_grow_forest_sharded_names_its_item():
    """The sharded growth runs on one process's mesh (bitwise the
    single-device gini forest) and names its item in a gang of several
    processes."""
    from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh, make_mesh

    x, rs = _task("gini")
    n, d = x.shape
    w, _, uniforms = _draws(jax.random.key(2), 3, n, d, 3)
    edges = pt.quantize_features(torch.from_numpy(x), 8)
    args = (pt.bin_features(torch.from_numpy(x), edges), torch.from_numpy(rs), torch.from_numpy(w.copy()), edges,
            uniforms)
    kw = dict(max_depth=3, n_bins=8, impurity="gini", feat_subset=3)
    mesh = make_mesh((8, 1), devices=[torch.device("cpu")] * 8)
    for f, a, b in zip(FIELDS, pt.grow_forest_sharded(mesh, *args, **kw), pt.grow_forest(*args, **kw)):
        assert _bits_equal(a, b), f
    gang = np.empty((1, 1), dtype=object)
    gang[0, 0] = torch.device("cpu")
    with pytest.raises(NotImplementedError, match=r"A\.9, item 18 \(gang\)"):
        pt.grow_forest_sharded(Mesh(gang, processes=2), *args, **kw)


# --- prediction --------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gini", "entropy", "variance"])
@pytest.mark.parametrize("depth", [1, 4])
def test_forest_apply_and_predictions_match_the_reference(kind, depth):
    x, want, got = _grow_both(kind, depth=depth)
    xq = np.concatenate([x[:200], _features(100, x.shape[1], seed=99, scale=2.0)])
    want_idx = np.asarray(jt.forest_apply(jnp.asarray(xq), want, depth))
    got_idx = pt.forest_apply(torch.from_numpy(xq), got, depth)
    assert got_idx.dtype == torch.int32 and np.array_equal(got_idx.numpy(), want_idx)
    if kind == "variance":
        want_p = np.asarray(jt.forest_predict_reg(jnp.asarray(xq), want, depth))
        got_p = pt.forest_predict_reg(torch.from_numpy(xq), got, depth)
        assert_close("regression prediction", got_p, want_p, rtol=1e-5, atol=1e-5)
    else:
        want_p = np.asarray(jt.forest_predict_proba(jnp.asarray(xq), want, depth))
        got_p = pt.forest_predict_proba(torch.from_numpy(xq), got, depth)
        assert _bits_equal(got_p, want_p)
        assert_close("probability sum", got_p.sum(1), np.ones(len(xq)), rtol=0, atol=1e-5)


# --- draws and importances -------------------------------------------------


@pytest.mark.parametrize("rate", [0.5, 1.0])
def test_bootstrap_weights_are_clamped_integral_poisson(rate):
    w = pt.sample_weights(torch.Generator().manual_seed(1), 4, 50_000, rate, True)
    assert w.dtype == torch.float32 and w.shape == (4, 50_000)
    assert torch.equal(w, torch.round(w)) and float(w.max()) <= 256.0 and float(w.min()) >= 0.0
    assert float(w.mean()) == pytest.approx(rate, abs=0.02)
    assert float(w.var()) == pytest.approx(rate, abs=0.05)  # Poisson: variance = mean
    ref = np.asarray(jt.sample_weights(jax.random.key(1), 4, 50_000, rate, True))
    assert float(w.mean()) == pytest.approx(float(ref.mean()), abs=0.02)


def test_the_clamp_binds_at_256():
    gen = torch.Generator().manual_seed(0)
    assert float(pt.sample_weights(gen, 1, 100, 300.0, True).max()) == 256.0


@pytest.mark.parametrize("rate", [0.3, 1.0])
def test_subsampling_without_replacement_is_bernoulli(rate):
    w = pt.sample_weights(torch.Generator().manual_seed(2), 3, 40_000, rate, False)
    assert set(torch.unique(w).tolist()) <= {0.0, 1.0}
    assert float(w.mean()) == pytest.approx(rate, abs=0.02)


def test_the_generator_makes_draws_repeatable():
    a = pt.sample_weights(torch.Generator().manual_seed(5), 2, 1000, 1.0, True)
    b = pt.sample_weights(torch.Generator().manual_seed(5), 2, 1000, 1.0, True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["gini", "entropy", "variance"])
def test_feature_importances_match_the_reference(kind):
    _, want, _ = _grow_both(kind)
    forest = pt.Forest(*(torch.from_numpy(np.array(a)) for a in want))
    ours = pt.feature_importances(forest, 6)
    theirs = jt.feature_importances(want, 6)
    assert_close("importances", ours, theirs, rtol=1e-12, atol=1e-12)
    assert ours.sum() == pytest.approx(1.0)


def test_feature_importances_of_a_stump_forest_are_zero():
    _, want, got = _grow_both("gini", depth=0)
    assert np.array_equal(pt.feature_importances(got, 6), np.zeros(6))
    assert np.array_equal(pt.feature_importances(got, 6), jt.feature_importances(want, 6))
