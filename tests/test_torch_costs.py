"""The port's cost ledger (``observability/costs.py``) against the JAX
package's, after the reference's ``tests/test_costs.py``.

- **Schema**: a port document passes the reference's ``validate_ledger``
  and a reference document the port's; ``merge_ledger_docs`` and
  ``family_rollup`` of a mixed pair are equal between the packages
  (exactly, the merge's ``ts`` aside); the key rendering and specs are
  the reference's; ``tools/tpuml_prof.py`` renders and validates a port
  document.
- **Retrace watchdog**: the same serving calls (row buckets, a cache of
  two, evictions, shapes forced inside a bucket) give the same
  classifications, the same ``compile.*`` counters and the same one storm
  warning in both packages, exactly.
- **Off and on**: every family's fit and served output with the ledger on,
  and with the tuner on but holding no evidence (probe walls injected),
  is bitwise its run with both off; the disabled serve path stays within
  the reference's allocation budget (64 KiB a call) and records nothing.
- **Counts**: each kernel's ``cost`` is the formula of the kernel table's
  bound column (``PERF.md`` §6), a fused pipeline's count is the sum of
  its stages', and an entry's ``flops`` is its count.
- **Report and telemetry**: ``RunReport.costs`` rows carry the reference's
  keys, the HBM attribution is the reference's on the same samples, the
  sampler thread stops, and a 2-rank gloo gang's shards merge in
  ``gang_report`` (counters summed, watermarks at their maximum). This
  file is that gang's worker: ``python tests/test_torch_costs.py PORT OUT``.
"""

import json
import os
import socket
import subprocess
import sys
import tracemalloc
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from spark_rapids_ml_tpu_torch import device as port_device  # noqa: E402
from spark_rapids_ml_tpu_torch.core import serving as tserving  # noqa: E402
from spark_rapids_ml_tpu_torch.observability import autotune as tautotune  # noqa: E402
from spark_rapids_ml_tpu_torch.observability import costs as tcosts  # noqa: E402
from spark_rapids_ml_tpu_torch.observability import events as tevents  # noqa: E402
from spark_rapids_ml_tpu_torch.observability import report as treport  # noqa: E402
from spark_rapids_ml_tpu_torch.ops import precision as tprec  # noqa: E402
from spark_rapids_ml_tpu_torch.utils import tracing as ttracing  # noqa: E402

WORLD = 2
TIMEOUT = 120


def _kernel(x, w):
    return x @ w


def _kernel2(x, w):
    return x @ w + 1.0


# --- the gang worker ----------------------------------------------------------


def _worker(port: int, out: str) -> None:
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.parallel import distributed as tdist

    port_device.set_platform("cpu")
    tdist.initialize(coordinator_address=f"127.0.0.1:{port}")
    rank = tdist.process_index()
    x = np.random.default_rng(5).normal(size=(160, 6))
    model = PCA().setDeployMode("gang").setK(2).fit([x[:90] if rank == 0 else x[90:]])
    for n in (5, 30):  # two served buckets on each rank
        model.transform(x[:n])
    tcosts.active().observe_watermark("0", 100 * (rank + 1), 1000 * (rank + 1))
    np.save(f"{out}.{rank}.npy", model.pc)
    __import__("torch.distributed", fromlist=["destroy_process_group"]).destroy_process_group()
    print(f"OK rank {rank}")


# --- fixtures -----------------------------------------------------------------


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    tserving.clear_program_cache()
    yield
    tserving.clear_program_cache()
    port_device.set_platform("cuda")


def _disarm(monkeypatch):
    for name in ("TPUML_COST_LEDGER", "TPUML_AUTOTUNE", "TPUML_TUNE_STORE", "TPUML_HBM_SAMPLE_EVERY_MS",
                 "TPUML_RETRACE_STORM", "TPUML_SERVING_CACHE_SIZE"):
        monkeypatch.delenv(name, raising=False)
    tcosts.reset_for_tests()
    tautotune.reset_for_tests()


@pytest.fixture
def both_ledgers(monkeypatch):
    """Armed, empty ledgers in both packages, counters cleared."""
    from spark_rapids_ml_tpu.core import serving as jserving
    from spark_rapids_ml_tpu.observability import costs as jcosts
    from spark_rapids_ml_tpu.utils import tracing as jtracing

    monkeypatch.setenv("TPUML_COST_LEDGER", "1")
    jserving.clear_program_cache()
    for tr in (jtracing, ttracing):
        tr.clear_counters("compile.")
    jcosts.reset_for_tests()
    tcosts.reset_for_tests()
    try:
        yield jcosts
    finally:
        monkeypatch.delenv("TPUML_COST_LEDGER")
        monkeypatch.delenv("TPUML_SERVING_CACHE_SIZE", raising=False)
        jcosts.reset_for_tests()
        tcosts.reset_for_tests()
        jserving.clear_program_cache()


@pytest.fixture
def ledger(monkeypatch):
    monkeypatch.setenv("TPUML_COST_LEDGER", "1")
    ttracing.clear_counters("compile.")
    tcosts.reset_for_tests()
    try:
        yield tcosts.active()
    finally:
        _disarm(monkeypatch)


def _port_doc(rng) -> dict:
    """A port document from served buckets, a bypass run and a segment."""
    w = torch.from_numpy(rng.normal(size=(6, 3)))
    for n in (4, 30, 200):
        tserving.serve_rows(_kernel, rng.normal(size=(n, 6)), (w,), name="costs.kernel")
    tcosts.ledgered_call(_kernel, (torch.ones((5, 6), dtype=torch.float64), w), static={}, name="costs.seg")
    return tcosts.ledger_snapshot()


def _jax_doc(rng) -> dict:
    import jax.numpy as jnp
    from spark_rapids_ml_tpu.core import serving as jserving
    from spark_rapids_ml_tpu.observability import costs as jcosts

    w = jnp.asarray(rng.normal(size=(6, 3)))
    for n in (4, 30):
        jserving.serve_rows(_kernel, rng.normal(size=(n, 6)), (w,), name="costs.kernel")
    return jcosts.ledger_snapshot()


# --- schema -------------------------------------------------------------------


class TestSchema:
    def test_documents_pass_both_validators(self, both_ledgers, rng):
        jcosts = both_ledgers
        ours, theirs = _port_doc(rng), _jax_doc(rng)
        assert tcosts.LEDGER_VERSION == jcosts.LEDGER_VERSION and tcosts.ENTRY_FIELDS == jcosts.ENTRY_FIELDS
        assert jcosts.validate_ledger(ours) == [] and tcosts.validate_ledger(ours) == []
        assert tcosts.validate_ledger(theirs) == [] == jcosts.validate_ledger(theirs)
        assert set(ours) == set(theirs)
        for e in ours["entries"]:
            assert set(e) == set(theirs["entries"][0])
        assert {e["kind"] for e in ours["entries"]} == {"aot", "segment"}

    def test_specs_keys_and_markers(self, ledger, rng):
        from spark_rapids_ml_tpu.observability import costs as jcosts

        doc = _port_doc(rng)
        aot = sorted((e for e in doc["entries"] if e["kind"] == "aot"), key=lambda e: e["rows"])
        assert [e["spec"] for e in aot] == ["8x6:float64", "32x6:float64", "256x6:float64"]
        for e in aot:
            assert e["key"].startswith(f"costs.kernel|aot|{e['spec']}|") and len(e["key"].rsplit("|", 1)[1]) == 10
            # Off CUDA no temp bytes are measured: the reference's marker.
            assert e["unavailable"] == ["cost_analysis", "memory_analysis"] and e["flops"] is None
        # The key rendering is the reference's for the same identity.
        ident = ("costs.kernel", "aot", "a=1", "8x6:float64", ("(*,)", (((6, 3), "float64"),)))
        assert tcosts.ledger_key(*ident) == jcosts.ledger_key(*ident)

    def test_merge_and_rollup_agree_exactly(self, both_ledgers, rng):
        jcosts = both_ledgers
        ours, theirs = _port_doc(rng), _jax_doc(rng)
        theirs["watermarks"] = {"0": {"in_use": 7, "peak_bytes": 9}}
        ours["watermarks"] = {"0": {"in_use": 3, "peak_bytes": 11}}
        for docs in ([ours, theirs], [theirs, ours], [ours, ours]):
            a, b = tcosts.merge_ledger_docs(docs), jcosts.merge_ledger_docs(docs)
            a.pop("ts"), b.pop("ts")
            assert a == b
            assert tcosts.family_rollup(a) == jcosts.family_rollup(b)
        merged = tcosts.merge_ledger_docs([ours, theirs])
        assert merged["watermarks"] == {"0": {"in_use": 7, "peak_bytes": 11}}
        assert tcosts.family_rollup(ours) == jcosts.family_rollup(ours)

    def test_tpuml_prof_renders_a_port_document(self, ledger, rng, tmp_path, capsys):
        from tools import tpuml_prof

        path = tmp_path / "led.json"
        _port_doc(rng)
        assert tcosts.dump_ledger(str(path)) == str(path)
        assert tpuml_prof.main([str(path), "--validate"]) == 0
        assert tpuml_prof.main([str(path), "--sort", "wall"]) == 0
        out = capsys.readouterr().out
        assert "costs.kernel" in out and "per-family rollup" in out
        assert tpuml_prof.main(["--diff", str(path), str(path), "--max-regress", "10"]) == 0


# --- the retrace watchdog -------------------------------------------------------


def _classes(tracing_mod) -> dict:
    return {k: v for k, v in tracing_mod.counters("compile.").items() if v}


class TestWatchdog:
    def test_serving_sequence_classifies_like_the_reference(self, both_ledgers, monkeypatch, rng):
        import jax.numpy as jnp
        from spark_rapids_ml_tpu.core import serving as jserving
        from spark_rapids_ml_tpu.utils import tracing as jtracing

        monkeypatch.setenv("TPUML_SERVING_CACHE_SIZE", "2")
        w = rng.normal(size=(4, 2))
        wj, wt = jnp.asarray(w), torch.from_numpy(w)
        ours, theirs = [], []
        for n in (5, 30, 5, 200, 30, 5, 30, 3, 7, 250):
            x = rng.normal(size=(n, 4))
            for tr, serve, wts, seq in ((ttracing, tserving.serve_rows, wt, ours),
                                        (jtracing, jserving.serve_rows, wj, theirs)):
                before = _classes(tr)
                serve(_kernel, x, (wts,), name="costs.seq")
                after = _classes(tr)
                seq.append(sorted(k for k in after if after[k] != before.get(k, 0)))
        assert ours == theirs
        assert _classes(ttracing) == _classes(jtracing)
        assert _classes(ttracing).get("compile.eviction_refill", 0) >= 2
        assert "compile.retrace" not in _classes(ttracing)

    def test_bucket_bypass_storm_like_the_reference(self, both_ledgers, rng):
        import jax
        import jax.numpy as jnp
        from spark_rapids_ml_tpu.core import serving as jserving

        jcosts = both_ledgers
        w = np.ones((4, 2))
        wj, wt = jnp.asarray(w), torch.from_numpy(w)
        caught = {}
        for pkg in ("ours", "theirs"):
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                for rows in (16, 12, 11, 10, 9):
                    if pkg == "ours":
                        tserving._get_program(_kernel, rows, 4, torch.float64, torch.device("cpu"), (wt,), {},
                                              "costs.bypass")
                    else:
                        jserving._get_program(_kernel, jax.ShapeDtypeStruct((rows, 4), jnp.float64), (wj,), {},
                                              donate=False, name="costs.bypass")
            caught[pkg] = [str(w_.message) for w_ in got if issubclass(w_.category, Warning)
                           and "recompiled" in str(w_.message)]
        assert caught["ours"] == caught["theirs"] and len(caught["ours"]) == 1
        assert "costs.bypass" in caught["ours"][0]
        ours, theirs = tcosts.ledger_snapshot(), jcosts.ledger_snapshot()
        assert ours["retraces"] == theirs["retraces"] == {"total": 4, "families": {"costs.bypass": 4}}
        assert issubclass(tcosts.RetraceStormWarning, UserWarning)

    def test_descending_buckets_and_a_reset_are_no_retraces(self, both_ledgers, rng):
        import jax.numpy as jnp
        from spark_rapids_ml_tpu.core import serving as jserving
        from spark_rapids_ml_tpu.utils import tracing as jtracing

        w = rng.normal(size=(4, 2))
        for n in (5000, 7, 16, 9):
            tserving.serve_rows(_kernel2, rng.normal(size=(n, 4)), (torch.from_numpy(w),), name="costs.desc")
            jserving.serve_rows(_kernel2, rng.normal(size=(n, 4)), (jnp.asarray(w),), name="costs.desc")
        tserving.clear_program_cache()
        jserving.clear_program_cache()
        tserving.serve_rows(_kernel2, rng.normal(size=(7, 4)), (torch.from_numpy(w),), name="costs.desc")
        jserving.serve_rows(_kernel2, rng.normal(size=(7, 4)), (jnp.asarray(w),), name="costs.desc")
        assert _classes(ttracing) == _classes(jtracing)
        assert _classes(ttracing) == {"compile.new_program": 2, "compile.new_bucket": 2}

    def test_a_ladder_rung_is_a_bucket(self, ledger):
        tcosts.set_row_bucket_probe(lambda rows: rows == 12)
        try:
            w = torch.ones((4, 2), dtype=torch.float64)
            for rows in (16, 12, 11):
                tserving._get_program(_kernel, rows, 4, torch.float64, torch.device("cpu"), (w,), {}, "costs.rung")
        finally:
            tcosts.set_row_bucket_probe(None)
        assert _classes(ttracing) == {"compile.new_program": 1, "compile.new_bucket": 1, "compile.retrace": 1}

    def test_two_models_of_one_shape_are_two_programs(self, ledger, rng):
        """A graph binds its weights' addresses: a second model of the same
        shapes captures programs of its own, which are no retraces."""
        for _ in range(2):
            w = torch.from_numpy(rng.normal(size=(4, 2)))
            tserving.serve_rows(_kernel, rng.normal(size=(5, 4)), (w,), name="costs.twins")
        assert _classes(ttracing) == {"compile.new_program": 2}


# --- off and on: bitwise --------------------------------------------------------


def _dyadic(rng, shape):
    return rng.integers(-16, 16, size=shape).astype(np.float64) / 4.0


def _run_family(family: str, tmp_path, monkeypatch, rng_seed: int = 3):
    """One family's fit and served outputs, as host arrays."""
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.clustering import KMeans
    from spark_rapids_ml_tpu_torch.evaluation import BinaryClassificationEvaluator
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.manifold import UMAP
    from spark_rapids_ml_tpu_torch.pipeline import Pipeline
    from spark_rapids_ml_tpu_torch.regression import LinearRegression

    rng = np.random.default_rng(rng_seed)
    x = rng.normal(size=(96, 5)) * np.linspace(1.0, 2.0, 5)
    y = (x[:, 0] + 0.3 * x[:, 1] > 0).astype(np.float64)
    if family.endswith("_segmented"):
        monkeypatch.setenv("TPUML_CHECKPOINT_EVERY", "2")
        monkeypatch.setenv("TPUML_CHECKPOINT_DIR", str(tmp_path / f"ck-{os.environ.get('TPUML_COST_LEDGER')}"
                                                                  f"-{os.environ.get('TPUML_AUTOTUNE')}"))
    if family == "pca":
        m = PCA().setK(3).fit(x)
        return [m.pc, m.explainedVariance, m.transform(x[:37])]
    if family == "kmeans":
        m = KMeans().setK(3).setSeed(1).fit(x.astype(np.float32))
        return [np.asarray(m.clusterCenters()), m.predict(x[:21])]
    if family == "kmeans_segmented":
        m = KMeans(uid="seg").setK(3).setSeed(1).setTol(0.0).setMaxIter(6).fit(x)
        return [np.asarray(m.clusterCenters()), np.asarray(m.numIter)]
    if family == "linear_segmented":
        m = LinearRegression(uid="seg").setRegParam(0.1).setElasticNetParam(0.5).fit((x, x @ np.arange(5.0)))
        return [np.asarray(m.coefficients), np.asarray(m.intercept), m.predict(x[:9])]
    if family == "logistic_segmented":
        m = LogisticRegression(uid="seg").setRegParam(0.01).setMaxIter(8).setTol(0.0).fit((x, y))
        return [np.asarray(m.coefficients), np.asarray(m.intercept), m.predictProbability(x[:9])]
    if family == "umap_segmented":
        monkeypatch.setenv("TPUML_CHECKPOINT_UMAP", "1")
        m = UMAP(uid="seg").setNNeighbors(5).setNEpochs(12).setSeed(0).fit(x[:60])
        return [np.asarray(m.embedding)]
    if family == "auc":
        s = torch.from_numpy(x[:, 0] + 0.1 * x[:, 2])
        return [np.asarray(BinaryClassificationEvaluator().evaluate((torch.from_numpy(y), s)))]
    if family == "pipeline":
        xd = _dyadic(rng, (40, 5))
        model = Pipeline(stages=[PCA().setK(3), LogisticRegression().setMaxIter(5)]).fit((xd, (xd[:, 0] > 0) * 1.0))
        return [np.asarray(model.transform(xd[:11]))]
    raise AssertionError(family)


def _probe_f32_fastest(monkeypatch):
    monkeypatch.setattr(tprec, "_time_probe",
                        lambda a, b, mode, repeats=3: ((a @ b).numpy(), {"f32": 1.0}.get(mode, 2.0)))


FAMILIES = ["pca", "kmeans", "kmeans_segmented", "linear_segmented", "logistic_segmented", "umap_segmented",
            "auc", "pipeline"]

#: Ledger families each run records (beyond served programs).
RECORDED = {
    "pca": {"covariance.gram"},
    "kmeans": {"kmeans.lloyd"},
    "kmeans_segmented": {"kmeans.lloyd.segment"},
    "linear_segmented": {"linear.enet.segment"},
    "logistic_segmented": {"logistic.lbfgs.segment"},
    "umap_segmented": {"umap.layout.segment", "umap.tail"},
    "auc": {"metrics.binary_auc"},
    "pipeline": {"covariance.gram"},
}


@pytest.mark.parametrize("mode", ["ledger", "tuner"])
@pytest.mark.parametrize("family", FAMILIES)
def test_fits_and_outputs_are_bitwise_with_the_ledger_and_tuner_on(monkeypatch, tmp_path, family, mode):
    _disarm(monkeypatch)
    off = _run_family(family, tmp_path, monkeypatch)
    if mode == "ledger":
        monkeypatch.setenv("TPUML_COST_LEDGER", "1")
    else:
        _probe_f32_fastest(monkeypatch)
        monkeypatch.setenv("TPUML_AUTOTUNE", "on")
        monkeypatch.setenv("TPUML_TUNE_STORE", str(tmp_path / "tune.json"))
    tcosts.reset_for_tests()
    tautotune.reset_for_tests()  # the tuner arms the ledger
    tserving.clear_program_cache()
    try:
        on = _run_family(family, tmp_path, monkeypatch)
        doc = tcosts.ledger_snapshot()
    finally:
        _disarm(monkeypatch)
    assert len(on) == len(off)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert tcosts.validate_ledger(doc) == []
    families = {e["family"] for e in doc["entries"]}
    assert RECORDED[family] <= families
    for e in doc["entries"]:
        if e["kind"] != "aot":
            assert e["flops"] is not None and e["flops"] > 0 and e["invocations"] >= 1


def test_disabled_path_records_nothing_within_the_budget(monkeypatch, rng):
    _disarm(monkeypatch)
    w = torch.from_numpy(rng.normal(size=(4, 2)))
    x = rng.normal(size=(5, 4))
    tserving.serve_rows(_kernel, x, (w,), name="costs.disabled")  # warm the bucket
    ttracing.clear_counters("compile.")
    before = tevents.emitted_count()
    n = 200
    tracemalloc.start()
    base, _ = tracemalloc.get_traced_memory()
    for _ in range(n):
        tserving.serve_rows(_kernel, x, (w,), name="costs.disabled")
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert tcosts.active() is None and tcosts.ledger_snapshot() is None
    assert _classes(ttracing) == {} and tevents.emitted_count() == before
    assert peak - base < n * 65536
    assert tcosts.ledgered_call(_kernel, (torch.ones(2, 4, dtype=torch.float64), w), static={}, name="x") is not None


# --- the counts -------------------------------------------------------------------


class TestCounts:
    @pytest.mark.parametrize("n,d,dtype", [(1000, 7, torch.float32), (1_048_576, 1024, torch.float32),
                                           (300, 5, torch.float64)])
    def test_k1_counts_the_bound_columns_work(self, n, d, dtype):
        from spark_rapids_ml_tpu_torch.ops.kernels import covariance

        item = 4 if dtype == torch.float32 else 8
        assert covariance.cost(n, d, dtype) == {"flops": n * d * (d + 1), "transcendentals": 0.0,
                                                "bytes_accessed": (n * d + d + d * d) * item}

    @pytest.mark.parametrize("n,d,k", [(20_000_000, 16, 100), (20_000_000, 16, 16), (33, 3, 2)])
    def test_k2_k3_count_the_bound_columns_work(self, n, d, k):
        from spark_rapids_ml_tpu_torch.ops.kernels import kmeans

        assert kmeans.cost(n, d, k) == {"flops": 2.0 * n * k * d, "transcendentals": 0.0,
                                        "bytes_accessed": 4 * (n * d + k * d) + 4 * k * d + 8 * k + 4 + 4 * k}

    @pytest.mark.parametrize("n,e,dim", [(50_000, 750_000, 2), (10, 30, 3)])
    def test_k4_counts_the_bound_columns_work(self, n, e, dim):
        from spark_rapids_ml_tpu_torch.ops.kernels import umap

        assert umap.cost(n, e, dim) == {"flops": e * dim, "transcendentals": 0.0,
                                        "bytes_accessed": 4 * e * dim + 4 * e + 4 * (n + 1) + 4 * n * dim}

    def test_signature_counts_and_a_composite_sums_its_stages(self, rng):
        from spark_rapids_ml_tpu_torch.classification import LogisticRegression
        from spark_rapids_ml_tpu_torch.feature import PCA
        from spark_rapids_ml_tpu_torch.pipeline import Pipeline

        x = _dyadic(rng, (40, 6))
        model = Pipeline(stages=[PCA().setK(3), LogisticRegression().setMaxIter(3)]).fit((x, (x[:, 0] > 0) * 1.0))
        composite = model.serving_signature()
        pca_sig, log_sig = (s.serving_signature() for s in model.stages)
        p, lo = pca_sig.cost(64), log_sig.cost(64, dtype=torch.float64)
        assert p["flops"] == 2 * 64 * 6 * 3 and p["bytes_accessed"] == (64 * 6 + 6 * 3 + 64 * 3) * 8
        assert lo["flops"] == 2 * 64 * 3 * 1 and lo["transcendentals"] == 64
        total = composite.cost(64, dtype=torch.float64)
        for f in ("flops", "transcendentals", "bytes_accessed"):
            assert total[f] == p[f] + lo[f]

    def test_entries_carry_their_counts(self, ledger, rng):
        from spark_rapids_ml_tpu_torch.clustering import KMeans
        from spark_rapids_ml_tpu_torch.feature import PCA

        x = rng.normal(size=(50, 4))
        PCA().setK(2).fit(x).transform(x[:20])
        KMeans().setK(3).setSeed(0).fit(x).predict(x[:3])
        by = {e["family"]: e for e in tcosts.ledger_snapshot()["entries"]}
        assert by["covariance.gram"]["flops"] == 50 * 4 * 5
        assert by["kmeans.lloyd"]["flops"] == 2.0 * 50 * 3 * 4
        assert by["pca.transform"]["flops"] == 2 * 32 * 4 * 2  # the 32-row bucket
        assert by["kmeans.predict"]["flops"] == 2.0 * 8 * 3 * 4
        assert by["kmeans.predict"]["rows_served"] == 3 and by["pca.transform"]["rows_served"] == 20


# --- report, sampler and telemetry -------------------------------------------------


class TestReport:
    def test_run_report_rows_have_the_references_keys(self, both_ledgers, rng, tmp_path, monkeypatch):
        from spark_rapids_ml_tpu.clustering import KMeans as JaxKMeans
        from spark_rapids_ml_tpu_torch.clustering import KMeans

        monkeypatch.setenv("TPUML_CHECKPOINT_EVERY", "2")
        x = rng.normal(size=(60, 4))
        monkeypatch.setenv("TPUML_CHECKPOINT_DIR", str(tmp_path / "a"))
        theirs = JaxKMeans().setK(3).setSeed(1).fit(x).fit_report()
        monkeypatch.setenv("TPUML_CHECKPOINT_DIR", str(tmp_path / "b"))
        ours = KMeans().setK(3).setSeed(1).fit(x).fit_report()
        t_rows = [r for r in theirs.costs if r["family"] == "kmeans.lloyd.segment"]
        o_rows = [r for r in ours.costs if r["family"] == "kmeans.lloyd.segment"]
        assert len(t_rows) == len(o_rows) == 1 and set(o_rows[0]) == set(t_rows[0])
        assert set(ours.summary()) == set(theirs.summary()) and "costs" in ours.summary()
        assert "where the FLOPs and bytes went" in str(ours)
        assert o_rows[0]["flops"] == 2.0 * 60 * 3 * 4 and o_rows[0]["utilization"] is None
        monkeypatch.setenv("TPUML_PEAK_FLOPS", "1e9")
        monkeypatch.setenv("TPUML_PEAK_BYTES_PER_SEC", "1e9")
        row = tcosts.roofline_row(dict(o_rows[0], wall_seconds=o_rows[0]["wall_seconds"]))
        assert row["utilization"] is not None and row["utilization"] > 0

    def test_roofline_row_matches_the_reference(self, monkeypatch):
        from spark_rapids_ml_tpu.observability import costs as jcosts

        monkeypatch.setenv("TPUML_PEAK_FLOPS", "2e9")
        monkeypatch.setenv("TPUML_PEAK_BYTES_PER_SEC", "4e9")
        entry = {"key": "k", "family": "fam.x", "kind": "aot", "invocations": 4, "wall_seconds": 0.5,
                 "flops": 1e8, "bytes_accessed": 3e8}
        assert tcosts.roofline_row(entry) == jcosts.roofline_row(entry)
        assert tcosts.device_peaks() == jcosts.device_peaks() == {"flops_per_sec": 2e9, "bytes_per_sec": 4e9}

    def test_a_modes_passes_scale_its_flops_roof(self, monkeypatch):
        monkeypatch.setenv("TPUML_PEAK_FLOPS", "1e9")
        tprec.resolve_policy("kmeans", "bf16x3")
        try:
            row = tcosts.roofline_row({"family": "kmeans.lloyd", "invocations": 1, "wall_seconds": 1.0,
                                       "flops": 1e8})
        finally:
            tprec.reset_for_tests()
        assert row["precision_mode"] == "bf16x3" and row["utilization"] == pytest.approx(0.3)

    def test_hbm_attribution_matches_the_reference(self):
        from spark_rapids_ml_tpu.observability import costs as jcosts

        samples = [(0.0, 10, 100), (1.0, 20, 150), (2.0, 15, 150), (3.0, 40, 400), (4.5, 40, 420)]
        spans = [{"name": "fit", "start": 0.0, "end": 5.0, "depth": 0},
                 {"name": "place rows", "start": 2.5, "end": 3.5, "depth": 1}]
        ours = tcosts.attribute_hbm_growth(samples, spans)
        assert ours == jcosts.attribute_hbm_growth(samples, spans)
        assert ours["by_span"] == {"fit": 70, "place rows": 250} and ours["delta"] == 320
        assert tcosts.attribute_hbm_growth(samples[:1], spans) == {}

    def test_sampler_publishes_and_stops(self, ledger, monkeypatch):
        stats = iter([{"0": {"bytes_in_use": 5, "peak_bytes_in_use": 9}}] * 3
                     + [{"0": {"bytes_in_use": 7, "peak_bytes_in_use": 30}}] * 1000)
        smp = tcosts.HbmSampler(period_ms=1.0, stats_fn=lambda: next(stats))
        for _ in range(4):
            smp.sample_once()
        assert [s[2] for s in smp.samples] == [9, 9, 9, 30]
        assert tcosts.ledger_snapshot()["watermarks"] == {"0": {"in_use": 7, "peak_bytes": 30}}
        smp.start()
        assert smp.alive()
        smp.stop()
        assert not smp.alive()
        # The knob starts the module's sampler; a reset stops it. Off CUDA
        # the default stats are empty, so nothing is sampled.
        monkeypatch.setenv("TPUML_HBM_SAMPLE_EVERY_MS", "2")
        tcosts.configure()
        live = tcosts.sampler()
        assert live is not None and live.alive() and live.sample_once() is None
        tcosts.reset_for_tests()
        monkeypatch.delenv("TPUML_HBM_SAMPLE_EVERY_MS")
        tcosts.reset_for_tests()
        assert not live.alive() and tcosts.sampler() is None

    def test_report_hbm_attributes_growth_to_the_fit(self, ledger, monkeypatch, rng):
        from spark_rapids_ml_tpu_torch.feature import PCA

        peaks = iter(range(100, 10**9, 100))
        monkeypatch.setenv("TPUML_HBM_SAMPLE_EVERY_MS", "1")
        monkeypatch.setattr(tcosts, "_default_hbm_stats",
                            lambda: {"0": {"bytes_in_use": 1, "peak_bytes_in_use": next(peaks)}})
        tcosts.configure()
        try:
            smp = tcosts.sampler()
            model = PCA().setK(2).fit(rng.normal(size=(3000, 40)))
            smp.sample_once()
        finally:
            monkeypatch.delenv("TPUML_HBM_SAMPLE_EVERY_MS")
            tcosts.configure()
        hbm = model.fit_report().hbm
        assert set(hbm) == {"peak_start", "peak_end", "delta", "by_span"} or hbm == {}
        if hbm:
            assert hbm["delta"] > 0 and sum(hbm["by_span"].values()) == hbm["delta"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_two_rank_gangs_cost_shards_merge(tmp_path):
    from spark_rapids_ml_tpu.observability import report as jreport
    from spark_rapids_ml_tpu_torch.parallel import distributed as tdist

    tdir = tmp_path / "telemetry"
    out = str(tmp_path / "gang")
    port = _free_port()
    base = {**os.environ, "JAX_PLATFORMS": "cpu", tevents.TELEMETRY_DIR_ENV: str(tdir), "TPUML_COST_LEDGER": "1"}
    envs = [tdist.member_env(rank, WORLD, base=base) for rank in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(port), out], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(REPO))
             for env in envs]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{stderr[-3000:]}"
        assert f"OK rank {rank}" in stdout
    np.testing.assert_array_equal(np.load(f"{out}.0.npy"), np.load(f"{out}.1.npy"))
    docs = tcosts.load_ledger_dir(str(tdir))
    assert len(docs) == WORLD and all(tcosts.validate_ledger(d) == [] for d in docs)
    rep = treport.gang_report(str(tdir))
    merged = rep["costs"]["merged"]
    assert rep["costs"]["members"] == WORLD and merged["merged_from"] == WORLD
    assert merged["watermarks"] == {"0": {"in_use": 200, "peak_bytes": 2000}}
    per_key = {}
    for d in docs:
        for e in d["entries"]:
            per_key.setdefault(e["key"], []).append(e)
    for e in merged["entries"]:
        cells = per_key[e["key"]]
        for f in ("invocations", "rows_served", "compiles"):
            assert e[f] == sum(c[f] for c in cells)
    served = [e for e in merged["entries"] if e["family"] == "pca.transform"]
    assert len(served) == 2 and all(e["invocations"] == WORLD for e in served)
    theirs = jreport.gang_report(str(tdir))["costs"]["merged"]
    theirs.pop("ts"), merged.pop("ts")
    assert theirs == merged


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2])
