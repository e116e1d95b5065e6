"""The port's autotuner (``observability/autotune.py``) against the JAX
package's, after the reference's ``tests/test_autotune.py``.

- **Pure logic, both packages on the same inputs**: ``fit_cost_models``
  and ``_linfit`` (models within 1e-12), ``recommend_block_rows`` and
  ``recommend_kmeans_block_rows`` under one fit budget, ``note_oom``, the
  serving ladder, ``recommend_delay_s``, ``price_input_bytes``,
  ``record_trial`` and ``measure_and_commit`` (clocks injected) give equal
  decisions and equal store files; a store written by either package
  loads in the other; a corrupt file reads as an empty store.
- **Decision points in the port**: off is the static branch; the ladder
  admits a hot size, its outputs at the new rung are bitwise the eager
  kernel at that rung (dyadic rows), the capture is a bucket, not a
  retrace, and the drop closes the program the size left; the batcher's
  window follows the measured p95; the fit guard prices through the
  fitted bytes model; the streaming recovery halves once on an OOM,
  records it with ``note_oom`` and equals the explicit reader fit at the
  block it used; the precision gate (probe walls injected) commits what
  the reference's commits, rejects a parity miss and reads its store
  without probing again.

Every test that arms the tuner or sets a store undoes it.
"""

import json
import time
import types

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.observability import autotune as jautotune
from spark_rapids_ml_tpu.observability import costs as jcosts
from spark_rapids_ml_tpu.ops import precision as jprec
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.core import membudget as tmb
from spark_rapids_ml_tpu_torch.core import serving as tserving
from spark_rapids_ml_tpu_torch.core.data import HostArrayBlockReader, fit_block_rows
from spark_rapids_ml_tpu_torch.observability import autotune as tautotune
from spark_rapids_ml_tpu_torch.observability import costs as tcosts
from spark_rapids_ml_tpu_torch.ops import precision as tprec
from spark_rapids_ml_tpu_torch.utils import tracing as ttracing

TOL = 1e-12


def _kernel(x, w):
    return x @ w


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    tserving.clear_program_cache()
    yield
    tserving.clear_program_cache()
    port_device.set_platform("cuda")


@pytest.fixture
def tuner(monkeypatch, tmp_path):
    """An armed port tuner (hot_min 3, a fresh store file); torn down to off."""
    monkeypatch.setenv("TPUML_AUTOTUNE", "on")
    monkeypatch.setenv("TPUML_AUTOTUNE_HOT_MIN", "3")
    monkeypatch.setenv("TPUML_TUNE_STORE", str(tmp_path / "tune.json"))
    for prefix in ("autotune.", "compile.", "fit.", "serving."):
        ttracing.clear_counters(prefix)
    tcosts.reset_for_tests()
    tautotune.reset_for_tests()
    t = tautotune.active()
    assert t is not None and tcosts.active() is not None  # the tuner arms the ledger
    try:
        yield t
    finally:
        for name in ("TPUML_AUTOTUNE", "TPUML_AUTOTUNE_HOT_MIN", "TPUML_TUNE_STORE"):
            monkeypatch.delenv(name)
        tcosts.reset_for_tests()
        tautotune.reset_for_tests()


def _pair(tmp_path, hot_min=3):
    """A port and a reference tuner over store files of their own."""
    return (tautotune.Autotuner(tautotune.TuneStore(str(tmp_path / "ours.json")), hot_min=hot_min),
            jautotune.Autotuner(jautotune.TuneStore(str(tmp_path / "theirs.json")), hot_min=hot_min))


def _entries(cls):
    """Synthetic ledger entries (one ProgramCost class per package)."""
    out = []
    for fam, rows, inv, wall, mem in [
        ("m.serve", 100, 4, 4 * (2e-6 * 100 + 5e-4), (4800 + 1000, 0, 0)),
        ("m.serve", 400, 4, 4 * (2e-6 * 400 + 5e-4), (19200 + 1000, 0, 0)),
        ("m.serve", 1600, 4, 4 * (2e-6 * 1600 + 5e-4), (76800 + 1000, 0, 0)),
        ("m.serve", 400, 2, 2 * 1.3e-3, (None, None, None)),
        ("kmeans.lloyd.segment", 5000, 3, 0.6, (None, None, None)),
        ("cold", 100, 0, 0.0, (None, None, None)),
        ("rowless", None, 5, 1.0, (None, None, None)),
    ]:
        e = cls(key=f"{fam}|aot|{rows}", family=fam, kind="aot", static="", spec="", rows=rows,
                classification="new_program", invocations=inv, wall_seconds=wall,
                argument_bytes=mem[0], temp_bytes=mem[1], output_bytes=mem[2],
                bytes_accessed=None if fam != "kmeans.lloyd.segment" else 4.0 * rows * 16)
        out.append(e)
    return out


def _close(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return a is not None and b is not None and abs(a - b) <= TOL * max(1.0, abs(b))
    return a == b


def _decisions(path):
    doc = json.load(open(path))
    return {k: {f: v for f, v in d.items() if f != "updated"} for k, d in doc["decisions"].items()}


def _fixed_clock(monkeypatch, module, step=0.25):
    """``module.time`` with a perf_counter that advances ``step`` a read
    and a fixed wall clock: trials and store stamps become deterministic."""
    ticks = iter(range(10**6))
    monkeypatch.setattr(module, "time", types.SimpleNamespace(
        perf_counter=lambda: step * next(ticks), time=lambda: 1.7e9))


# --- the pure logic -------------------------------------------------------------


class TestCostModels:
    def test_models_match_the_reference(self):
        ours = tautotune.fit_cost_models(_entries(tcosts.ProgramCost))
        theirs = jautotune.fit_cost_models(_entries(jcosts.ProgramCost))
        assert set(ours) == set(theirs) == {"m.serve", "kmeans.lloyd.segment"}
        for fam in ours:
            a, b = ours[fam].as_dict(), theirs[fam].as_dict()
            assert set(a) == set(b)
            for f in a:
                assert _close(a[f], b[f]), (fam, f, a[f], b[f])
            for rows in (1, 300, 10**6):
                assert _close(ours[fam].predict_wall(rows), theirs[fam].predict_wall(rows))
                assert ours[fam].predict_bytes(rows) == theirs[fam].predict_bytes(rows)

    @pytest.mark.parametrize("pts", [[], [(10, 2.0)], [(10, 2.0), (10, 4.0)], [(1, 5.0), (2, 3.0), (3, 1.0)],
                                     [(100, 0.1), (200, 0.25), (400, 0.41), (400, 0.39)]])
    def test_linfit_matches_the_reference(self, pts):
        a, b = tautotune._linfit(pts), jautotune._linfit(pts)
        assert all(_close(x, y) for x, y in zip(a, b))
        assert tautotune._p95([3.0, 1.0, 2.0] * 7) == jautotune._p95([3.0, 1.0, 2.0] * 7)


class TestDecisions:
    @pytest.mark.parametrize("budget", [None, "0", str(2**20), str(3 * 2**30)])
    def test_block_rows_match_the_reference(self, monkeypatch, tmp_path, budget):
        if budget is None:
            monkeypatch.delenv("TPUML_FIT_MEM_BUDGET", raising=False)
        else:
            monkeypatch.setenv("TPUML_FIT_MEM_BUDGET", budget)
        ours, theirs = _pair(tmp_path)
        for t, cls, mod in ((ours, tcosts.ProgramCost, tautotune), (theirs, jcosts.ProgramCost, jautotune)):
            fitted = mod.fit_cost_models(_entries(cls))
            monkeypatch.setattr(t, "models", lambda fitted=fitted: dict(fitted))
        cases = [("m.serve", dict(default=65536, width=None)), ("m", dict(default=65536, width=8, itemsize=8)),
                 ("nothing", dict(default=4096, width=16)), ("nothing", dict(default=100))]
        for fam, kw in cases:
            assert ours.recommend_block_rows(fam, **kw) == theirs.recommend_block_rows(fam, **kw)
        for n, k, shards in ((20_000_000, 100, 1), (1000, 8, 2), (10**9, 1000, 4)):
            assert ours.recommend_kmeans_block_rows(n, k, shards) == theirs.recommend_kmeans_block_rows(n, k, shards)
        for fam, rows in (("m.serve", 123), ("kmeans", 9000), ("nope", 5)):
            assert ours.price_input_bytes(fam, rows) == theirs.price_input_bytes(fam, rows)
        assert ours.hbm_headroom() == theirs.hbm_headroom()

    def test_note_oom_matches_the_reference(self, monkeypatch, tmp_path):
        ours, theirs = _pair(tmp_path)
        _fixed_clock(monkeypatch, tautotune)
        _fixed_clock(monkeypatch, jautotune)
        for t in (ours, theirs):
            t.note_oom("pca", 65536)
            t.note_oom("pca", 131072)  # a larger failure keeps the lower ceiling
            t.note_oom("kmeans", 300)
        assert ours.snapshot()["oom_ceilings"] == theirs.snapshot()["oom_ceilings"] == {"pca": 32768, "kmeans": 256}
        assert _decisions(tmp_path / "ours.json") == _decisions(tmp_path / "theirs.json")
        for fam in ("pca", "kmeans", "other"):
            assert ours.recommend_block_rows(fam, default=65536) == theirs.recommend_block_rows(fam, default=65536)

    def test_ladder_matches_the_reference(self, monkeypatch, tmp_path):
        ours, theirs = _pair(tmp_path)
        _fixed_clock(monkeypatch, tautotune)
        _fixed_clock(monkeypatch, jautotune)
        seq = [3, 3, 3, 3, 100, 100, 5, 100, 37, 37, 37, 7, 7, 7, 100] + list(range(9, 20)) * 3
        picks = {"ours": [], "theirs": []}
        for n in seq:
            d = tserving.bucket_rows(n)
            picks["ours"].append(ours.serving_bucket("lad.kern", 6, n, d))
            picks["theirs"].append(theirs.serving_bucket("lad.kern", 6, n, d))
        assert picks["ours"] == picks["theirs"]
        assert ours.snapshot()["ladders"] == theirs.snapshot()["ladders"]
        assert len(ours.snapshot()["ladders"]["lad.kern|6"]) == tautotune.MAX_LADDER_RUNGS
        for n in (1, 3, 4, 36, 50, 99, 101):
            d = tserving.bucket_rows(n)
            assert ours.peek_serving_bucket("lad.kern", 6, n, d) == theirs.peek_serving_bucket("lad.kern", 6, n, d)
        assert _decisions(tmp_path / "ours.json") == _decisions(tmp_path / "theirs.json")
        assert ours.is_ladder_bucket(3) and not ours.is_ladder_bucket(4)

    def test_delay_matches_the_reference(self, tmp_path):
        ours, theirs = _pair(tmp_path)
        rng = np.random.default_rng(0)
        for t in (ours, theirs):
            assert t.recommend_delay_s("kmeans.predict", 0.005) == 0.005  # no samples yet
        for _ in range(30):
            rows, wall = int(rng.choice([8, 16, 64])), float(rng.uniform(1e-4, 3e-3))
            for t in (ours, theirs):
                t.observe_wall("kmeans.predict", rows, wall)
                t.observe_wall("pca.transform", rows, wall * 100)
        for fam, default in (("kmeans.predict", 0.005), ("kmeans", 0.005), ("pca.transform", 0.005), ("x", 0.1)):
            assert ours.recommend_delay_s(fam, default) == theirs.recommend_delay_s(fam, default)
        assert ours.recommend_delay_s("pca.transform", 0.005) <= 0.25  # capped
        # The router's threshold (item 17b reads it) agrees too.
        for t, cls, mod in ((ours, tcosts.ProgramCost, tautotune), (theirs, jcosts.ProgramCost, jautotune)):
            fitted = mod.fit_cost_models(_entries(cls))
            t.models = lambda fitted=fitted: dict(fitted)
        assert ours.recommend_shard_rows("m.serve") == theirs.recommend_shard_rows("m.serve")

    def test_trials_match_the_reference(self, monkeypatch, tmp_path):
        ours, theirs = _pair(tmp_path)
        _fixed_clock(monkeypatch, tautotune)
        _fixed_clock(monkeypatch, jautotune)
        script = [("fit_block_rows", "fam", 16384, 1.0, {}), ("fit_block_rows", "fam", 65536, 2.0, {}),
                  ("fit_block_rows", "fam", 65536, 1.5, {}), ("fit_block_rows", "fam", 32768, 0.5, {}),
                  ("fit_block_rows", "fam", 32768, 0.4, {}), ("precision_mode", "pca", "bf16", 0.1,
                                                               dict(ok=False, reason="parity")),
                  ("precision_mode", "pca", "f32", 0.3, {}), ("precision_mode", "pca", "bf16x3", 0.2, {})]
        for knob, key, value, metric, kw in script:
            assert ours.record_trial(knob, key, value, metric, **kw) == theirs.record_trial(knob, key, value,
                                                                                           metric, **kw)
        results = [t.measure_and_commit("fit_block_rows", "other", 4096, lambda: "done", rows=1000)
                   for t in (ours, theirs)]
        assert results[0][0] == results[1][0] == "done" and results[0][1:] == results[1][1:]
        assert _decisions(tmp_path / "ours.json") == _decisions(tmp_path / "theirs.json")
        assert ours.store.get("fit_block_rows", "fam")["value"] == 32768


class TestTuneStore:
    def test_files_load_across_the_packages(self, tmp_path):
        ours, theirs = _pair(tmp_path)
        for t in (ours, theirs):
            t.record_trial("fit_block_rows", "pca", 8192, 0.5)
            t.note_oom("kmeans", 4096)
            for _ in range(3):
                t.serving_bucket("km", 16, 20, 32)
        for src, mod in (("ours.json", jautotune), ("theirs.json", tautotune)):
            loaded = mod.Autotuner(mod.TuneStore(str(tmp_path / src)), hot_min=3)
            assert not loaded.store.corrupt
            assert loaded.store.get("fit_block_rows", "pca")["value"] == 8192
            assert loaded.snapshot()["ladders"] == {"km|16": [20]}
            assert loaded.snapshot()["oom_ceilings"] == {"kmeans": 2048}
        doc = json.load(open(tmp_path / "ours.json"))
        assert doc["version"] == jautotune.STORE_VERSION == tautotune.STORE_VERSION

    @pytest.mark.parametrize("content", ["{not json", '{"decisions": []}', "[1, 2]"])
    def test_a_corrupt_store_reads_empty_with_a_counter(self, tmp_path, content):
        path = tmp_path / "bad.json"
        path.write_text(content)
        before = ttracing.counter_value("autotune.store.corrupt")
        store = tautotune.TuneStore(str(path))
        assert store.corrupt and store.snapshot() == []
        assert ttracing.counter_value("autotune.store.corrupt") == before + 1
        assert jautotune.TuneStore(str(path)).corrupt
        store.put({"knob": "k", "key": "x", "value": 1})  # rewritten whole, atomically
        assert not tautotune.TuneStore(str(path)).corrupt

    def test_a_memory_store_and_a_gang_members_own_file(self, monkeypatch, tmp_path):
        store = tautotune.TuneStore(None)
        store.put({"knob": "k", "key": "x", "value": 1})
        assert store.get("k", "x")["value"] == 1 and store.path is None
        monkeypatch.setenv("TPUML_AUTOTUNE", "on")
        monkeypatch.setenv("TPUML_TUNE_STORE", str(tmp_path / "gang.json"))
        monkeypatch.setenv("TPUML_PROCESS_ID", "1")
        try:
            tcosts.reset_for_tests()
            tautotune.reset_for_tests()
            assert tautotune.active().store.path == str(tmp_path / "gang.json") + ".p1"
            assert tautotune.tuner_snapshot()["enabled"] is True
        finally:
            for name in ("TPUML_AUTOTUNE", "TPUML_TUNE_STORE", "TPUML_PROCESS_ID"):
                monkeypatch.delenv(name)
            tcosts.reset_for_tests()
            tautotune.reset_for_tests()
        assert tautotune.active() is None and tautotune.tuner_snapshot() is None
        assert tcosts._INVOCATION_OBSERVER is None and tcosts._ROW_BUCKET_PROBE is None


# --- the decision points in the port ----------------------------------------------


def _dyadic(rng, shape):
    return rng.integers(-16, 16, size=shape).astype(np.float64) / 4.0


class TestDecisionPoints:
    def test_off_is_the_static_branch(self, monkeypatch):
        monkeypatch.delenv("TPUML_AUTOTUNE", raising=False)
        tautotune.reset_for_tests()
        assert tautotune.active() is None
        assert fit_block_rows("pca", width=8) == 65536
        for n in (1, 3, 9, 100, 5000):
            assert tserving.ladder_bucket_rows(n, name="x", width=4) == tserving.bucket_rows(n)

    def test_a_hot_size_earns_an_exact_rung(self, tuner, rng):
        w = torch.from_numpy(_dyadic(rng, (6, 3)))
        x3 = _dyadic(rng, (3, 6))
        cold = [tserving.serve_rows(_kernel, x3, (w,), name="lad.kern") for _ in range(2)]
        assert tserving.program_cache_stats()["size"] == 1  # the 8-row bucket
        grew = tserving.serve_rows(_kernel, x3, (w,), name="lad.kern")  # third sighting: the rung
        warm = tserving.serve_rows(_kernel, x3, (w,), name="lad.kern")
        assert ttracing.counter_value("autotune.ladder.grow") == 1
        assert ttracing.counter_value("compile.retrace") == 0
        assert ttracing.counter_value("compile.new_bucket") == 1
        assert ttracing.counter_value("serving.cache.retired") == 0
        # The 8-row program the size left was dropped; the 3-row rung serves.
        stats = tserving.program_cache_stats()
        assert stats["size"] == 1 and stats["compiles"] == 2
        eager = (torch.from_numpy(x3) @ w).numpy()  # the kernel at the rung, eagerly
        for out in cold + [grew, warm]:
            np.testing.assert_array_equal(out, eager)
        assert tuner.peek_serving_bucket("lad.kern", 6, 3, 8) == 3 and tuner.is_ladder_bucket(3)
        # A size that still pads into 8 re-captures it as a refill.
        tserving.serve_rows(_kernel, _dyadic(rng, (5, 6)), (w,), name="lad.kern")
        assert ttracing.counter_value("compile.eviction_refill") == 1
        assert tuner.store.get("serving_ladder", "lad.kern|6")["value"] == [3]

    def test_the_runtime_admits_at_the_rung_and_waits_the_measured_window(self, tuner, rng):
        from spark_rapids_ml_tpu_torch.models.kmeans import KMeansModel
        from spark_rapids_ml_tpu_torch.serving import ServingRuntime

        model = KMeansModel("km", _dyadic(rng, (3, 4)))
        with ServingRuntime(max_batch=8, max_delay_ms=5.0) as rt:
            rt.register("km", model)
            rows = _dyadic(rng, (3, 4))
            outs = [rt.submit("km", rows).result(timeout=30) for _ in range(5)]
            batcher = rt._batcher
            req = types.SimpleNamespace(version=types.SimpleNamespace(signature=model.serving_signature()))
            for _ in range(10):
                tuner.observe_wall("kmeans.predict", 3, 0.002)
            window = batcher._delay_s_for(req)
            assert window == tuner.recommend_delay_s("kmeans.predict", 0.005) and window != 0.005
        for out in outs:
            np.testing.assert_array_equal(out, model.predict(rows))
        assert tuner.peek_serving_bucket("kmeans.predict", 4, 3, 8) == 3
        assert ttracing.counter_value("serving.admission.declared") >= 5

    def test_the_fit_guard_prices_through_the_bytes_model(self, tuner, monkeypatch):
        led = tcosts.active()
        for rows in (100, 200):
            key = f"pca.fake|aot|{rows}"
            with led._lock:
                led._entries[key] = tcosts.ProgramCost(
                    key=key, family="pca.fake", kind="aot", static="", spec="", rows=rows,
                    classification="new_program", argument_bytes=1000 * rows, temp_bytes=0, output_bytes=0)
        monkeypatch.setenv("TPUML_FIT_MEM_BUDGET", str(10**6))
        assert tmb.fit_memory_guard("pca", np.zeros((500, 3)), can_stream=True).degrade is False
        assert ttracing.counter_value("fit.admission.model_priced") == 1
        decision = tmb.fit_memory_guard("pca", np.zeros((2000, 3)), can_stream=True)
        assert decision.degrade and decision.needed_bytes == 1000 * 2000

    def test_the_streaming_recovery_halves_once_and_records_the_oom(self, tuner, rng, monkeypatch):
        from spark_rapids_ml_tpu_torch.clustering import KMeans
        from spark_rapids_ml_tpu_torch.robustness.faults import inject

        monkeypatch.setenv("TPUML_FIT_MEM_BUDGET", "1000")  # degrades the host fit to streaming
        monkeypatch.setenv("TPUML_FIT_BLOCK_ROWS", "512")
        x = rng.normal(size=(2000, 4)).astype(np.float32)
        with pytest.warns(Warning), inject("solver.segment=1:oom"):
            model = KMeans().setK(3).setSeed(2).setMaxIter(5).fit(x)
        assert ttracing.counter_value("fit.oom.block_halved") == 1
        ((family, ceiling),) = tuner.snapshot()["oom_ceilings"].items()
        assert ceiling == 256 and tuner.store.get("fit_oom_ceiling", family)["value"] == 256
        assert tuner.store.get("fit_block_rows", family)["value"] == 256  # the trial that ran
        assert tuner.recommend_block_rows(family, default=65536) == 256
        monkeypatch.setenv("TPUML_FIT_MEM_BUDGET", "0")
        explicit = KMeans().setK(3).setSeed(2).setMaxIter(5).fit(HostArrayBlockReader(x, block_rows=256))
        np.testing.assert_array_equal(np.asarray(model.clusterCenters()), np.asarray(explicit.clusterCenters()))


class TestPrecisionGate:
    @pytest.mark.parametrize("walls,family", [({"f32": 1.0, "bf16x3": 2.0, "bf16": 3.0}, "pca"),
                                              ({"f32": 3.0, "bf16x3": 1.0, "bf16": 2.0}, "kmeans"),
                                              ({"f32": 3.0, "bf16x3": 2.0, "bf16": 1.0}, "serving")])
    def test_commits_what_the_reference_commits(self, monkeypatch, tmp_path, walls, family):
        ours, theirs = _pair(tmp_path)
        _fixed_clock(monkeypatch, tautotune)
        _fixed_clock(monkeypatch, jautotune)
        monkeypatch.setattr(tprec, "_time_probe",
                            lambda a, b, mode, repeats=3: (tprec.make_dot(mode)(a, b).numpy(), walls[mode]))
        monkeypatch.setattr(jprec, "_time_probe",
                            lambda a, b, mode, repeats=3: (np.asarray(jprec._probe_gemm(a, b, mode)), walls[mode]))
        mode = tprec.tune_precision(family, tuner=ours)
        assert mode == jprec.tune_precision(family, tuner=theirs) == min(
            ("f32",) + tprec._CANDIDATES.get(family, tprec._DEFAULT_CANDIDATES), key=walls.get)
        a, b = _decisions(tmp_path / "ours.json"), _decisions(tmp_path / "theirs.json")
        assert a.keys() == b.keys()
        for key in a:
            assert a[key]["value"] == b[key]["value"] and a[key]["metric"] == b[key]["metric"]
            assert [r["reason"] for r in a[key]["rejected"]] == [r["reason"] for r in b[key]["rejected"]]
        # A second process reads the committed mode without probing.
        monkeypatch.setattr(tprec, "_time_probe", lambda *a, **k: pytest.fail("probed twice"))
        reread = tautotune.Autotuner(tautotune.TuneStore(str(tmp_path / "ours.json")))
        assert tprec.tune_precision(family, tuner=reread) == mode

    def test_a_parity_miss_is_rejected_however_fast(self, monkeypatch, tmp_path):
        ours, _ = _pair(tmp_path)
        tprec.register_test_mode("wrong", lambda a, b: 2.0 * (a @ b), rel_tol=1e-3)
        try:
            monkeypatch.setattr(tprec, "_time_probe",
                                lambda a, b, mode, repeats=3: (tprec.make_dot(mode)(a, b).numpy(),
                                                               {"f32": 1.0, "wrong": 0.01}[mode]))
            assert tprec.tune_precision("pca", tuner=ours, candidates=("wrong",)) == "f32"
        finally:
            tprec.clear_test_modes()
        dec = ours.store.get("precision_mode", "pca")
        assert dec["rejected"][-1]["value"] == "wrong" and dec["rejected"][-1]["reason"] == "parity"

    def test_the_real_probe_runs_and_resolve_policy_takes_its_mode(self, tuner):
        mode = tprec.resolve_policy("linear")
        assert mode in ("f32", "bf16x3") and tprec.active_mode("linear") == mode
        dec = tuner.store.get("precision_mode", "linear")
        assert dec["value"] == mode and dec["metric_name"] == "probe_seconds" and dec["metric"] > 0
        assert tprec.resolve_policy("linear", "bf16") == "bf16"  # explicit outranks the tuner
        tprec.reset_for_tests()


def test_time_probe_times_after_a_warm_up():
    a, b = torch.ones((4, 3)), torch.ones((3, 2))
    out, wall = tprec._time_probe(a, b, "f32", repeats=2)
    np.testing.assert_array_equal(out, np.full((4, 2), 3.0, dtype=np.float32))
    assert 0 < wall < 1.0
    assert time.perf_counter() > 0
