"""Crash safety of the port's lifecycle journal, on the CPU: a real
``SIGKILL`` mid-cycle at every stage, then this interpreter resumes the
SAME cycle and lands the SAME model; the register fence; torn, stale and
unknown-schema journals; and journals shared with the JAX package.

Mirrors ``tests/test_lifecycle_journal.py``. The kill harness is real: a
child process (this file run as a script, CPU platform, the port only: the
JAX package is imported inside the tests that compare with it)
arms a fatal fault at one stage and turns the injected fault into
``os.kill(getpid(), SIGKILL)``: no atexit handlers, no flushes. The
restart is what an operator would run: rebuild the in-memory serving
runtime, build a controller over the surviving journal directory, call
``run_cycle`` again. Per stage:

- the resumed cycle id is the killed cycle's id;
- the registry ends with exactly ONE version (the fence);
- the final incumbent's centres are bitwise those of an uninterrupted run
  (deterministic solver, journaled ingest split).

The specs reach every stage: a count ``N`` fails a site's first N hits,
so the refit, warm and flip stages need ``N@K`` (``refit.ingest=1@1``,
``refit.swap=1@1``, ``=1@2``); the child reports the stages its journal
holds when it dies. A journal written by either package is accepted by
the other's ``resume_or_start``, and both write the same file for the same
calls.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.clustering import KMeans
from spark_rapids_ml_tpu_torch.lifecycle import LifecycleController
from spark_rapids_ml_tpu_torch.lifecycle.controller import _load_pickle, next_cycle_id
from spark_rapids_ml_tpu_torch.lifecycle.journal import FILENAME, SCHEMA_VERSION, STAGES, CycleJournal
from spark_rapids_ml_tpu_torch.robustness import InjectedFault, inject
from spark_rapids_ml_tpu_torch.robustness.faults import disarm
from spark_rapids_ml_tpu_torch.serving.server import ServingRuntime
from spark_rapids_ml_tpu_torch.utils.tracing import clear_counters, counter_value

REPO = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT = 120
UID = "jk-km"
SEED = 3


def _data():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(240, 5))
    x[:120] += 4.0
    return x


def _km_score(model, x, y):
    centers = np.asarray(model.clusterCenters())
    d = np.linalg.norm(x[:, None, :] - centers[None], axis=2).min(axis=1)
    return -float(d.mean())


def _controller(directory, runtime=None):
    return LifecycleController(
        KMeans(uid=UID).setK(2).setSeed(SEED), runtime or ServingRuntime(start=False), "km",
        score_fn=_km_score, directory=str(directory),
    )


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    for name in ("TPUML_LIFECYCLE_DIR", "TPUML_FAULTS", "TPUML_CHECKPOINT_DIR", "TPUML_CHECKPOINT_EVERY"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TPUML_RETRY_BASE_DELAY", "0")
    port_device.set_platform("cpu")
    yield
    disarm()
    port_device.set_platform("cuda")


def child_main(directory: str, spec: str) -> int:
    """The killed controller: the port only, on the CPU platform."""
    port_device.set_platform("cpu")
    ctrl = _controller(directory)
    with inject(spec):
        try:
            ctrl.run_cycle(_data())
        except InjectedFault:
            path = os.path.join(directory, FILENAME)
            stages = sorted(json.loads(Path(path).read_text())["stages"]) if os.path.exists(path) else []
            print("STAGES " + json.dumps(stages), flush=True)
            os.kill(os.getpid(), signal.SIGKILL)  # no unwind, no flush, no atexit
    print("UNEXPECTED-COMPLETION", flush=True)
    return 0


#: (stage killed, spec, the stages journaled when it dies)
STAGE_SPECS = [
    ("ingest", "refit.ingest=1:fatal", []),
    ("refit", "refit.ingest=1@1:fatal", ["ingest"]),
    ("quality_gate", "refit.quality_gate=1:fatal", ["ingest", "refit"]),
    ("register", "refit.swap=1:fatal", ["ingest", "quality_gate", "refit"]),
    ("warm", "refit.swap=1@1:fatal", ["ingest", "quality_gate", "refit", "register"]),
    ("flip", "refit.swap=1@2:fatal", ["ingest", "quality_gate", "refit", "register", "warm"]),
]


class TestKillEveryStage:
    @pytest.fixture(scope="class")
    def reference_centers(self, tmp_path_factory):
        """The uninterrupted run every kill must reproduce."""
        port_device.set_platform("cpu")
        ctrl = _controller(tmp_path_factory.mktemp("ref"))
        out = ctrl.run_cycle(_data())
        assert out.action == "flipped" and out.version == 1
        return np.asarray(ctrl.model.clusterCenters())

    def test_the_stages_are_the_reference_stages(self):
        assert [s for s, _, _ in STAGE_SPECS] == list(STAGES)

    @pytest.mark.parametrize("stage,spec,journaled", STAGE_SPECS)
    def test_sigkill_then_resume_same_cycle(self, stage, spec, journaled, tmp_path, reference_centers):
        env = {k: v for k, v in os.environ.items() if not k.startswith("TPUML_")}
        env.update(PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""), TPUML_RETRY_BASE_DELAY="0")
        proc = subprocess.run(
            [sys.executable, __file__, "child", str(tmp_path), spec], env=env,
            capture_output=True, text=True, timeout=CHILD_TIMEOUT,
        )
        assert proc.returncode == -signal.SIGKILL, (stage, proc.returncode, proc.stdout, proc.stderr[-2000:])
        assert "UNEXPECTED-COMPLETION" not in proc.stdout
        assert f"STAGES {json.dumps(journaled)}" in proc.stdout, (stage, proc.stdout)

        clear_counters("lifecycle")
        ctrl = _controller(tmp_path)  # a fresh runtime: its registry is empty
        out = ctrl.run_cycle(_data())
        assert out.action == "flipped", (stage, out)
        assert out.cycle == 0, f"{stage}: resumed a different cycle"
        assert ctrl.runtime.registry.versions("km") == [1], f"{stage}: duplicate registration"
        assert ctrl.runtime.registry.aliases("km") == {"prod": 1}
        assert counter_value("lifecycle.journal.resumed") == (1 if journaled else 0)
        got = np.asarray(ctrl.model.clusterCenters())
        assert np.array_equal(got, reference_centers), f"{stage}: the resumed cycle diverged"
        j = json.loads((tmp_path / FILENAME).read_text())
        assert j["finished"] and j["cycle"] == 0 and sorted(j["stages"]) == sorted(STAGES)
        assert next_cycle_id(str(tmp_path)) == 1


class TestRegisterFence:
    def test_kill_between_register_and_mark_adopts_version(self, tmp_path):
        """The registry took the candidate but the journal never heard:
        re-entry adopts the version above the fence."""
        ctrl = _controller(tmp_path)
        x = _data()
        clear_counters("lifecycle")
        with inject("refit.swap=1:fatal"):
            with pytest.raises(InjectedFault):
                ctrl.run_cycle(x)
        journal = CycleJournal.resume_or_start(str(tmp_path), ctrl._identity, 99)
        assert journal.done("quality_gate") and not journal.done("register") and journal.fence() == 0
        candidate = _load_pickle(journal.payload("refit")["model"])
        ctrl.runtime.register("km", candidate)  # landed, never journaled
        resumed = _controller(tmp_path, ctrl.runtime)
        out = resumed.run_cycle(x)
        assert out.action == "flipped" and out.version == 1
        assert ctrl.runtime.registry.versions("km") == [1]
        assert counter_value("lifecycle.register.adopted") == 1

    def test_reborn_registry_re_registers_the_journaled_version(self, tmp_path):
        """Whole-process death after the register mark: the new registry
        is empty, so the candidate registers again and must land on the
        journaled version."""
        ctrl = _controller(tmp_path)
        with inject("refit.swap=1@1:fatal"):
            with pytest.raises(InjectedFault):
                ctrl.run_cycle(_data())
        out = _controller(tmp_path).run_cycle(_data())
        assert out.version == 1 and out.action == "flipped"

    def test_a_diverged_registry_is_refused(self, tmp_path):
        ctrl = _controller(tmp_path)
        with inject("refit.swap=1@1:fatal"):
            with pytest.raises(InjectedFault):
                ctrl.run_cycle(_data())
        rt = ServingRuntime(start=False)
        rt.register("km", ctrl.estimator.fit(_data()))
        rt.register("km", ctrl.estimator.fit(_data()))
        rt.retire("km", 1)
        with pytest.raises(Exception, match="diverged"):
            _controller(tmp_path, rt).run_cycle(_data())


class TestTornAndStaleJournal:
    ID = {"name": "km", "estimator": "KMeans"}

    def _write_valid(self, d, cycle=0):
        j = CycleJournal.resume_or_start(str(d), self.ID, cycle)
        j.mark("ingest", {"data": "x"})
        return j

    def test_torn_journal_rejected_with_fallback(self, tmp_path):
        self._write_valid(tmp_path)
        path = tmp_path / FILENAME
        raw = path.read_bytes()
        path.write_bytes(raw[: len(raw) // 2])
        clear_counters("lifecycle")
        j = CycleJournal.resume_or_start(str(tmp_path), self.ID, 7)
        assert j.cycle == 7 and not j.done("ingest")
        assert counter_value("lifecycle.journal.rejected") == 1
        assert (tmp_path / (FILENAME + ".rejected")).read_bytes() == raw[: len(raw) // 2]

    def test_stale_identity_rejected(self, tmp_path):
        self._write_valid(tmp_path)
        clear_counters("lifecycle")
        j = CycleJournal.resume_or_start(str(tmp_path), {"name": "km", "estimator": "LogisticRegression"}, 3)
        assert j.cycle == 3 and not j.done("ingest")
        assert counter_value("lifecycle.journal.rejected") == 1

    @pytest.mark.parametrize("doc", [
        {"schema": 999, "cycle": 0, "stages": {}, "identity": ID, "finished": False},
        {"schema": SCHEMA_VERSION, "stages": {}, "identity": ID, "finished": False},
        {"schema": SCHEMA_VERSION, "cycle": 0, "stages": [], "identity": ID, "finished": False},
        [1, 2, 3],
    ])
    def test_unknown_schema_rejected(self, tmp_path, doc):
        (tmp_path / FILENAME).write_text(json.dumps(doc))
        from spark_rapids_ml_tpu.lifecycle.journal import CycleJournal as JaxCycleJournal
        from spark_rapids_ml_tpu.utils import tracing as jax_tracing

        clear_counters("lifecycle")
        jax_tracing.clear_counters("lifecycle")
        j = CycleJournal.resume_or_start(str(tmp_path), self.ID, 2)
        assert j.cycle == 2 and counter_value("lifecycle.journal.rejected") == 1
        (tmp_path / FILENAME).write_text(json.dumps(doc))
        assert JaxCycleJournal.resume_or_start(str(tmp_path), self.ID, 2).cycle == 2
        assert jax_tracing.counter_value("lifecycle.journal.rejected") == 1

    def test_rejected_journal_never_wedges_the_controller(self, tmp_path):
        (tmp_path / FILENAME).write_text('{"schema": 1, "cyc')
        out = _controller(tmp_path).run_cycle(_data())
        assert out.action == "flipped" and out.version == 1 and out.cycle == 0


def _jax_journal():
    from spark_rapids_ml_tpu.lifecycle.journal import CycleJournal as JaxCycleJournal

    return JaxCycleJournal


class TestJournalsAcrossPackages:
    ID = {"name": "km", "estimator": "KMeans"}

    @staticmethod
    def _drive(cls, d):
        j = cls.resume_or_start(str(d), TestJournalsAcrossPackages.ID, 5)
        j.mark("ingest", {"data": "cycle_5_data.npz", "n_train": 192, "n_holdout": 48, "labeled": False})
        j.mark("refit", {"model": "cycle_5_candidate.pkl"})
        j.set_fence(2)
        return j

    @pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
    def test_a_journal_resumes_in_the_other_package(self, tmp_path, writer, reader):
        classes = {"jax": _jax_journal(), "port": CycleJournal}
        self._drive(classes[writer], tmp_path)
        j = classes[reader].resume_or_start(str(tmp_path), self.ID, 99)
        assert j.cycle == 5 and j.done("ingest") and j.done("refit") and not j.done("quality_gate")
        assert j.payload("ingest")["n_train"] == 192 and j.fence() == 2
        j.mark("quality_gate", {"passed": True, "candidate": -1.0, "incumbent": None})
        j.finish()
        back = classes[writer].resume_or_start(str(tmp_path), self.ID, 6)
        assert back.cycle == 6 and not back.done("ingest")

    def test_both_packages_write_the_same_file(self, tmp_path):
        for name, cls in (("jax", _jax_journal()), ("port", CycleJournal)):
            j = self._drive(cls, tmp_path / name)
            j.mark("quality_gate", {"passed": False, "candidate": -2.5, "incumbent": -1.25})
            j.finish()
        assert (tmp_path / "jax" / FILENAME).read_bytes() == (tmp_path / "port" / FILENAME).read_bytes()

    def test_a_rejected_journal_is_refused_by_both(self, tmp_path):
        self._drive(CycleJournal, tmp_path)
        other = {"name": "km", "estimator": "PCA"}
        assert _jax_journal().resume_or_start(str(tmp_path), other, 1).cycle == 1
        assert (tmp_path / (FILENAME + ".rejected")).exists()


if __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "child":
    sys.exit(child_main(sys.argv[2], sys.argv[3]))
