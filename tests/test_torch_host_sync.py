"""Counted host syncs (``utils/tracing.HostSync``), the ``kmeans seeding``
span and the eigensolver's decision counters, on the PCA and KMeans fit
routes.

The per-fit counts are pinned at what the same fits counted on an NVIDIA
H100 (torch 2.11, CUDA 12.8), where ``torch.cuda.set_sync_debug_mode``
saw no sync outside a ``HostSync``. The test marked ``cuda`` runs the
benchmark cells' fit routes at small shapes under that mode's ``"error"``;
this file imports nothing of JAX, so on a machine with a card it runs
without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_host_sync.py -q
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.clustering import KMeans
from spark_rapids_ml_tpu_torch.feature import PCA
from spark_rapids_ml_tpu_torch.ops.eigh import eigh_auto
from spark_rapids_ml_tpu_torch.utils import tracing
from spark_rapids_ml_tpu_torch.utils.tracing import HostSync, counter_value

#: Per-fit counters of the fits below (``sync.*`` and ``eigh.*``): 2 Lloyd
#: iterations; k-means++ makes one sync and then two a step for k - 1 steps;
#: eigh_auto stagnates after 2 subspace iterations and accepts.
KMEANS_K5 = {"sync.kmeans.seeding.neg_inf": 1, "sync.kmeans.seeding.pick": 4,
             "sync.kmeans.seeding.min_d2": 4, "sync.kmeans.lloyd.moved": 2}
#: The same KMeans fit on a card: K5 seeds a float32 CUDA tensor with no
#: host sync, so only Lloyd's remain.
KMEANS_K5_CARD = {k: v for k, v in KMEANS_K5.items() if not k.startswith("sync.kmeans.seeding.")}
PCA_AUTO = {"eigh.auto.calls": 1, "eigh.auto.iterations": 2, "sync.eigh.start_basis": 1,
            "sync.eigh.auto.s_prev": 1, "sync.eigh.auto.stagnation": 2, "sync.eigh.ritz": 1,
            "sync.eigh.auto.accept": 1}
PCA_PALLAS = {**PCA_AUTO, "sync.pca.trace_ratio": 2}


def _blobs(device="cpu"):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2000, 8)) + np.repeat(rng.normal(scale=20, size=(5, 8)), 400, axis=0)
    return torch.from_numpy(x.astype(np.float32)).to(device)


FITS = {
    "kmeans": (lambda x: KMeans().setK(5).setSeed(1).fit(x), KMEANS_K5),
    "pca_auto": (lambda x: PCA().setK(3).fit(x), PCA_AUTO),
    "pca_pallas": (lambda x: PCA().setK(3).setCovarianceBackend("pallas").fit(x), PCA_PALLAS),
}


def _counts(model) -> dict:
    return {k: v for k, v in model.fit_report().counters.items() if k.startswith(("sync.", "eigh."))}


def _span_names() -> list:
    return [name for name, _, _ in tracing.recent_events()]


def test_a_host_sync_counts_every_exit_and_spans_only_under_a_profiler():
    before = counter_value("sync.test.site")
    tracing.clear_events()
    with HostSync("test.site"):
        pass
    with pytest.raises(ValueError), HostSync("test.site"):
        raise ValueError("the body raised")
    assert counter_value("sync.test.site") == before + 2
    assert "sync test.site" not in _span_names()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with HostSync("test.site"):
            torch.ones(4).sum()
    assert counter_value("sync.test.site") == before + 3
    assert _span_names().count("sync test.site") == 1
    assert "sync test.site" in {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("fit", list(FITS))
def test_each_fit_reports_its_own_syncs(fit):
    run, expected = FITS[fit]
    x = _blobs()
    first, second = _counts(run(x)), _counts(run(x))
    assert first == second == expected


def test_the_seeding_span_nests_in_the_fit_outside_lloyd():
    tree = KMeans().setK(5).setSeed(1).fit(_blobs()).fit_report().stage_tree()
    assert [n["name"] for n in tree] == ["kmeans fit"]
    children = tree[0]["children"]
    assert [c["name"] for c in children] == ["ingest", "kmeans seeding", "kmeans lloyd"]
    seeding = children[1]
    assert not any(c["name"].startswith("kmeans lloyd") for c in seeding["children"])


def _spectrum_matrix(spectrum) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    q, _ = torch.linalg.qr(torch.randn(64, 64, generator=g, dtype=torch.float64))
    return ((q * torch.as_tensor(spectrum, dtype=torch.float64)) @ q.T).float()


@pytest.mark.parametrize("spectrum, max_iters, promoted, iterations", [
    (np.r_[100.0, 50.0, 25.0, 12.0, np.full(60, 0.1)], 16, 0, 4),
    (np.linspace(1.0, 0.5, 64), 1, 1, 1),
])
def test_eigh_auto_counts_its_calls_iterations_and_promotions(spectrum, max_iters, promoted, iterations):
    names = ("eigh.auto.calls", "eigh.auto.iterations", "eigh.auto.promoted", "sync.eigh.full")
    before = [counter_value(n) for n in names]
    *_, was_promoted = eigh_auto(_spectrum_matrix(spectrum), 2, max_iters=max_iters)
    assert was_promoted is bool(promoted)
    assert [counter_value(n) - b for n, b in zip(names, before)] == [1, iterations, promoted, promoted]


def _outputs(fit, x):
    model = FITS[fit][0](x)
    if fit == "kmeans":
        return model.clusterCenters(), model.trainingCost, model.numIter
    return model.pc, model.explainedVariance


@pytest.mark.parametrize("fit", list(FITS))
def test_a_profiled_fit_is_bitwise_an_unprofiled_one(fit):
    x = _blobs()
    plain = _outputs(fit, x)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = _outputs(fit, x)
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.cuda
def test_no_sync_on_the_cells_fit_routes_goes_uncounted():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    port_device.set_platform("cuda")
    port_device.use_ieee_fp32_matmul()
    g = torch.Generator(device="cuda").manual_seed(0)
    spectrum = 1.0 + 30.0 * 0.8 ** torch.arange(1024, device="cuda").clamp(max=40)
    xp = torch.randn(65_536, 1024, device="cuda", generator=g) * spectrum
    centres = 50.0 * torch.randn(100, 16, device="cuda", generator=g)
    pick = torch.randint(0, 100, (200_000,), device="cuda", generator=g)
    xk = centres[pick] + torch.randn(200_000, 16, device="cuda", generator=g)
    xs = _blobs("cuda")
    routes = [lambda: PCA().setK(16).setCovarianceBackend("pallas").fit(xp),
              lambda: KMeans().setK(100).setSeed(7).fit(xk)] + [lambda f=f: FITS[f][0](xs) for f in FITS]
    for route in routes:  # builds K1 and K2 and makes every first call
        route()
    torch.cuda.synchronize()
    models = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            bool(xs.sum() > 0)  # the mode sees a sync outside HostSync
        for route in routes:
            models.append(route())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    pca, kmeans, *small = models
    assert _counts(pca)["sync.eigh.auto.stagnation"] == _counts(pca)["eigh.auto.iterations"]
    assert _counts(kmeans).get("sync.kmeans.seeding.pick", 0) == 0
    assert _counts(kmeans).get("sync.kmeans.seeding.min_d2", 0) == 0
    assert _counts(kmeans).get("sync.kmeans.seeding.neg_inf", 0) == 0
    assert _counts(kmeans)["sync.kmeans.lloyd.moved"] >= 1
    on_card = {**{f: want for f, (_, want) in FITS.items()}, "kmeans": KMEANS_K5_CARD}
    assert [_counts(m) for m in small] == [on_card[f] for f in FITS]
