"""Gang fits over ``torch.distributed`` (gloo) on the CPU: two ranks.

This file is its own worker: ``python tests/test_torch_multiprocess.py
CASE PORT OUT`` joins a 2-rank gloo gang at ``127.0.0.1:PORT`` (rank and
world size come from the environment ``member_env`` builds), fits its half
of a seeded dataset and writes its results to ``OUT.<rank>.npz``. Each
spawning test starts both ranks with its own timeout, checks that they
return bitwise identical results, and holds them to the JAX package's
single-process fit of the concatenated rows on its (8, 1) mesh at the
family tolerances of ``test_torch_mesh_families.py`` (PCA components 1e-8
up to sign, ratios 1e-10; covariances 1e-10; logistic 1e-5 with equal
``numIter``; linear 1e-7; KMeans centres 1e-8).

The in-process cases need no gang: ``GangReinitWarning``, ``member_env``,
``deployMode`` and ``TPUML_GANG_FIT``, the process-local entry points in a
process of their own (where they equal the reference's), and a gang of
one of each sharded family (neighbours, ANN, UMAP, DBSCAN, forests), which
fits on the global mesh and equals its (1, 1) mesh fit bit for bit. In a
2-rank gang those families raise ``NotImplementedError`` naming "item 18
(gang)": the reference's routes take the whole matrix on every process.
"""

import json
import os
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from spark_rapids_ml_tpu_torch import device as port_device  # noqa: E402
from spark_rapids_ml_tpu_torch.parallel import distributed as tdist  # noqa: E402

N, D, SPLIT = 203, 7, 120
WORLD = 2
TIMEOUT = 120


def dataset():
    rng = np.random.default_rng(515)
    x = rng.normal(size=(N, D)) * np.linspace(1.0, 2.5, D) + 2.0
    x[:60] += 5.0
    y_bin = (x[:, 0] - x[:, 3] + 0.4 * rng.normal(size=N) > 2.0).astype(np.float64)
    y_lin = x @ rng.normal(size=D) + 0.1 * rng.normal(size=N)
    return x, y_bin, y_lin


def local_rows(rank: int, empty_last: bool = False):
    x, y_bin, y_lin = dataset()
    if empty_last:
        lo, hi = (0, N) if rank == 0 else (N, N)
    else:
        lo, hi = (0, SPLIT) if rank == 0 else (SPLIT, N)
    return x[lo:hi], y_bin[lo:hi], y_lin[lo:hi]


INIT = dataset()[0][[0, 100, 150]] + 0.01


# --- the worker -----------------------------------------------------------


def _worker(case: str, port: int, out: str) -> None:
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.clustering import KMeans
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.regression import LinearRegression

    port_device.set_platform("cpu")
    tdist.initialize(coordinator_address=f"127.0.0.1:{port}")
    rank = tdist.process_index()
    x, y_bin, y_lin = local_rows(rank, empty_last=case == "empty")
    res = {}
    if case in ("pca", "empty"):
        model = PCA().setDeployMode("gang").setK(3).setEigenSolver("full").fit([x[:40], x[40:]])
        res["pc"], res["ratio"] = model.pc, model.explainedVariance
    if case in ("stream", "empty"):
        blocks = [x[i:i + 50] for i in range(0, x.shape[0], 50)]
        for merge in ("psum", "allgather"):
            mean, cov, n = tdist.streaming_covariance_process_local(
                iter(blocks), mesh=tdist.global_mesh(), merge=merge)
            res[f"{merge}_mean"], res[f"{merge}_cov"], res[f"{merge}_n"] = mean, cov, np.asarray(n)
        model = PCA().setDeployMode("gang").setK(3).setEigenSolver("full").fit(lambda: iter(blocks))
        res["stream_pc"], res["stream_ratio"] = model.pc, model.explainedVariance
    if case == "logistic":
        model = LogisticRegression().setDeployMode("gang").setRegParam(0.01).fit((x, y_bin))
        res["weights"], res["intercepts"] = model.weights, model.intercepts
        res["num_iter"] = np.asarray(model.numIter)
    if case == "sharded":
        for family, fit in sharded_fits(x, y_bin).items():
            try:
                fit(lambda est: est.setDeployMode("gang"))
                res[family] = np.asarray("fitted")
            except NotImplementedError as exc:
                res[family] = np.asarray(str(exc))
    if case == "linear_kmeans":
        model = LinearRegression().setDeployMode("gang").setRegParam(0.1).fit((x, y_lin))
        res["coef"], res["intercept"] = model.coefficients, np.asarray(model.intercept)
        km = KMeans().setDeployMode("gang").setK(3).setInitialModel(INIT).fit(torch.from_numpy(x))
        res["centers"], res["cost"] = km.clusterCenters(), np.asarray(km.trainingCost)
        res["km_iter"] = np.asarray(km.numIter)
    np.savez(f"{out}.{rank}.npz", **res)
    world = tdist.process_count()
    torch.distributed.destroy_process_group()
    print(f"OK rank {rank}/{world}")


# --- spawning tests -------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_gang(case: str, tmp_path) -> list:
    port = _free_port()
    out = str(tmp_path / case)
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), case, str(port), out],
            env=tdist.member_env(rank, WORLD, base={**os.environ, "JAX_PLATFORMS": "cpu"}),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(REPO),
        )
        for rank in range(WORLD)
    ]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{stderr[-3000:]}"
        assert f"OK rank {rank}/{WORLD}" in stdout, stdout
    results = [dict(np.load(f"{out}.{rank}.npz")) for rank in range(WORLD)]
    assert results[0].keys() == results[1].keys()
    for key in results[0]:
        np.testing.assert_array_equal(results[0][key], results[1][key], err_msg=key)
    return results


def _jax_mesh():
    from spark_rapids_ml_tpu.parallel.mesh import make_mesh

    return make_mesh((8, 1))


def _components_close(got, want, atol):
    from spark_rapids_ml_tpu.utils.testing import assert_components_close

    assert_components_close(got, np.asarray(want), atol)


def _jax_pca(x):
    from spark_rapids_ml_tpu.feature import PCA as JaxPCA

    return JaxPCA(mesh=_jax_mesh()).setK(3).setEigenSolver("full").fit(x)


def test_gang_pca_matches_the_jax_mesh_fit(tmp_path):
    res = _run_gang("pca", tmp_path)[0]
    want = _jax_pca(dataset()[0])
    _components_close(res["pc"], want.pc, 1e-8)
    np.testing.assert_allclose(res["ratio"], np.asarray(want.explainedVariance), rtol=0, atol=1e-10)


def _check_streamed(res, x):
    import importlib

    jcov = importlib.import_module("spark_rapids_ml_tpu.ops.covariance")
    blocks = [x[i:i + 50] for i in range(0, x.shape[0], 50)]
    jmean, jc, jn = jcov.streaming_mean_and_covariance_mesh(iter(blocks), _jax_mesh())
    for merge in ("psum", "allgather"):
        assert int(res[f"{merge}_n"]) == jn == x.shape[0]
        np.testing.assert_allclose(res[f"{merge}_mean"], jmean, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(res[f"{merge}_cov"], jc, rtol=1e-10, atol=1e-12)
    want = _jax_pca(x)
    _components_close(res["stream_pc"], want.pc, 1e-8)
    np.testing.assert_allclose(res["stream_ratio"], np.asarray(want.explainedVariance), rtol=0, atol=1e-10)


def test_gang_streamed_covariance_psum_and_allgather_merges(tmp_path):
    _check_streamed(_run_gang("stream", tmp_path)[0], dataset()[0])


def test_an_empty_executor_strands_no_peer(tmp_path):
    res = _run_gang("empty", tmp_path)[0]
    x = dataset()[0]
    want = _jax_pca(x)
    _components_close(res["pc"], want.pc, 1e-8)
    _check_streamed(res, x)


def test_gang_logistic_matches_the_jax_mesh_fit(tmp_path):
    from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLogistic

    res = _run_gang("logistic", tmp_path)[0]
    x, y_bin, _ = dataset()
    want = JaxLogistic(mesh=_jax_mesh()).setRegParam(0.01).fit((x, y_bin))
    np.testing.assert_allclose(res["weights"], np.asarray(want.weights), rtol=0, atol=1e-5)
    np.testing.assert_allclose(res["intercepts"], np.asarray(want.intercepts), rtol=0, atol=1e-5)
    assert int(res["num_iter"]) == want.numIter


def test_gang_linear_and_kmeans_match_the_jax_mesh_fits(tmp_path):
    from spark_rapids_ml_tpu.clustering import KMeans as JaxKMeans
    from spark_rapids_ml_tpu.regression import LinearRegression as JaxLinear

    res = _run_gang("linear_kmeans", tmp_path)[0]
    x, _, y_lin = dataset()
    want = JaxLinear(mesh=_jax_mesh()).setRegParam(0.1).fit((x, y_lin))
    np.testing.assert_allclose(res["coef"], np.asarray(want.coefficients), rtol=0, atol=1e-7)
    np.testing.assert_allclose(res["intercept"], want.intercept, rtol=0, atol=1e-7)
    km = JaxKMeans(mesh=_jax_mesh()).setK(3).setInitialModel(INIT).fit(x)
    np.testing.assert_allclose(res["centers"], np.asarray(km.clusterCenters()), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res["cost"], km.trainingCost, rtol=1e-8)
    assert int(res["km_iter"]) == km.numIter


# --- in-process cases -----------------------------------------------------


@pytest.fixture
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


@pytest.fixture
def active_gang(monkeypatch):
    """The module state of a process that joined a gang (no group is
    formed: a second initialize() only compares coordinates)."""
    record = {"coordinator_address": "127.0.0.1:1234", "num_processes": 2, "process_id": 0}
    monkeypatch.setattr(tdist, "_initialized", True)
    monkeypatch.setattr(tdist, "_init_record", record)
    for name in ("TPUML_COORDINATOR", "TPUML_NUM_PROCESSES", "TPUML_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    return record


@pytest.mark.parametrize("field,kwargs", [
    ("coordinator_address", dict(coordinator_address="127.0.0.1:9999")),
    ("num_processes", dict(num_processes=4)),
    ("process_id", dict(process_id=1)),
])
def test_a_conflicting_reinitialize_names_its_field(active_gang, field, kwargs):
    with pytest.warns(tdist.GangReinitWarning) as caught:
        tdist.initialize(**kwargs)
    (warning,) = caught
    assert (warning.message.field, warning.message.active) == (field, active_gang[field])
    assert warning.message.requested == kwargs[field]


def test_a_matching_reinitialize_is_silent(active_gang, monkeypatch):
    monkeypatch.setenv("TPUML_NUM_PROCESSES", "2")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tdist.initialize(coordinator_address="127.0.0.1:1234", process_id=0)


def test_a_malformed_environment_reads_as_unknown_on_reinitialize(active_gang, monkeypatch):
    monkeypatch.setenv("TPUML_NUM_PROCESSES", "two")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tdist.initialize()


def test_initialize_needs_its_coordinates(monkeypatch):
    for name in ("TPUML_COORDINATOR", "TPUML_NUM_PROCESSES", "TPUML_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="coordinator address"):
        tdist.initialize()
    monkeypatch.setenv("TPUML_NUM_PROCESSES", "0")
    with pytest.raises(tdist.EnvKnobError, match="TPUML_NUM_PROCESSES"):
        tdist.initialize()


def test_member_env_matches_the_reference(monkeypatch):
    from spark_rapids_ml_tpu.parallel.distributed import member_env as jax_member_env

    base = {"TPUML_COORDINATOR": "host:1", "PATH": "/bin", "PYTHONPATH": "/elsewhere"}
    ours, theirs = tdist.member_env(3, 4, base=base), jax_member_env(3, 4, base=base)
    keys = ("TPUML_PROCESS_ID", "TPUML_NUM_PROCESSES", "PYTHONPATH", "PATH")
    assert {k: ours.get(k) for k in keys} == {k: theirs.get(k) for k in keys}
    assert "TPUML_COORDINATOR" not in ours and base["TPUML_COORDINATOR"] == "host:1"


_BRINGUP = r"""
import json, os, sys
import torch.distributed as dist
from spark_rapids_ml_tpu_torch import device
from spark_rapids_ml_tpu_torch.parallel import distributed as tdist
device.set_platform("cpu")
tdist.bringup_executor("127.0.0.1:" + sys.argv[1], 1, 0, chip_ordinal=2)
print(json.dumps({"visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "world": dist.get_world_size(),
                  "rank": dist.get_rank(), "backend": dist.get_backend(),
                  "mesh": list(tdist.global_mesh().grid.shape)}))
dist.destroy_process_group()
"""


def test_bringup_executor_waits_for_the_spark_item():
    """The Spark item is ported: ``bringup_executor`` pins the process to
    its card and joins a gang (gloo, a world of one, in a process of its
    own)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    r = subprocess.run([sys.executable, "-c", _BRINGUP, str(_free_port())], env=env,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == {"visible": "2", "world": 1, "rank": 0, "backend": "gloo", "mesh": [1, 1]}


@pytest.mark.parametrize("setting,mode", [(None, "single"), ("0", "single"), ("1", "gang")])
def test_gang_fit_knob_sets_the_default_deploy_mode(monkeypatch, setting, mode):
    from spark_rapids_ml_tpu.feature import PCA as JaxPCA
    from spark_rapids_ml_tpu_torch.feature import PCA

    if setting is None:
        monkeypatch.delenv("TPUML_GANG_FIT", raising=False)
    else:
        monkeypatch.setenv("TPUML_GANG_FIT", setting)
    assert PCA().getDeployMode() == JaxPCA().getDeployMode() == mode
    assert PCA().setDeployMode("single").getDeployMode() == "single"


def test_deploy_mode_refuses_what_the_reference_refuses():
    from spark_rapids_ml_tpu.feature import PCA as JaxPCA
    from spark_rapids_ml_tpu_torch.feature import PCA

    with pytest.raises(ValueError) as ours:
        PCA().setDeployMode("cluster")
    with pytest.raises(ValueError) as theirs:
        JaxPCA().setDeployMode("cluster")
    assert str(ours.value) == str(theirs.value)


def test_a_gang_of_one_fits_on_the_global_mesh(monkeypatch, cpu_platform):
    from spark_rapids_ml_tpu_torch.feature import PCA

    for name in ("TPUML_COORDINATOR", "TPUML_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TPUML_GANG_FIT", "1")
    x = dataset()[0]
    est = PCA().setK(3)
    model = est.fit(x)
    assert est.mesh is not None and est.mesh.shape == {"data": 1, "model": 1}
    _components_close(model.pc, PCA().setDeployMode("single").setK(3).fit(x).pc, 1e-10)


def sharded_fits(x, y_bin) -> dict:
    """One fit of each sharded family, its estimator set up by ``setup``
    (the deploy mode or a mesh), returning arrays to compare."""
    from spark_rapids_ml_tpu_torch.classification import RandomForestClassifier
    from spark_rapids_ml_tpu_torch.clustering import DBSCAN
    from spark_rapids_ml_tpu_torch.manifold import UMAP
    from spark_rapids_ml_tpu_torch.neighbors import ApproximateNearestNeighbors, NearestNeighbors

    def nearest_neighbors(setup):
        return setup(NearestNeighbors().setK(4)).fit(x).kneighbors(x[:20])

    def ann(setup):
        est = ApproximateNearestNeighbors().setK(4).setAlgoParams({"nlist": 6, "nprobe": 2})
        return setup(est).fit(x).kneighbors(x[:20])

    def umap(setup):
        return (setup(UMAP().setNNeighbors(6).setNEpochs(20).setSeed(0)).fit(x).embedding,)

    def dbscan(setup):
        model = setup(DBSCAN().setEps(1.2).setMinSamples(4)).fit(x)
        return model.labels_, model.core_mask_

    def random_forest(setup):
        model = setup(RandomForestClassifier().setNumTrees(4).setMaxDepth(3).setSeed(1)).fit((x, y_bin))
        return tuple(t.numpy() for t in model._forest)

    return {"nearest_neighbors": nearest_neighbors, "ann": ann, "umap": umap, "dbscan": dbscan,
            "random_forest": random_forest}


@pytest.mark.parametrize("family", ["nearest_neighbors", "ann", "umap", "dbscan", "random_forest"])
def test_a_gang_fit_of_a_family_without_a_mesh_route_names_its_item(monkeypatch, cpu_platform, family):
    """Each sharded family now has its mesh route: a gang of one fits on
    the global (1, 1) mesh and equals the family's (1, 1) mesh fit."""
    from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.delenv("TPUML_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("TPUML_COORDINATOR", raising=False)
    monkeypatch.setenv("TPUML_UMAP_SCATTER", "xla")
    x, y_bin, _ = dataset()
    fit = sharded_fits(x, y_bin)[family]
    estimators = []

    def gang(est):
        estimators.append(est)
        return est.setDeployMode("gang")

    got = fit(gang)
    assert estimators[0].mesh is not None and estimators[0].mesh.shape == {"data": 1, "model": 1}
    want = fit(lambda est: est.setMesh(make_mesh((1, 1), devices=[torch.device("cpu")])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_a_gang_of_two_refuses_the_sharded_families(tmp_path):
    results = _run_gang("sharded", tmp_path)
    for family in ("nearest_neighbors", "ann", "umap", "dbscan", "random_forest"):
        message = str(results[0][family])
        assert "item 18 (gang)" in message and "2 processes" in message, (family, message)


@pytest.mark.parametrize("merge", ["psum", "allgather"])
@pytest.mark.parametrize("center", [True, False])
def test_process_local_streaming_covariance_in_one_process(cpu_platform, merge, center):
    from spark_rapids_ml_tpu.parallel.distributed import (
        streaming_covariance_process_local as jax_streaming,
    )

    x = dataset()[0]
    blocks = [x[:70], x[70:]]
    mean, cov, n = tdist.streaming_covariance_process_local(iter(blocks), center=center,
                                                            mesh=tdist.global_mesh(), merge=merge)
    jmean, jc, jn = jax_streaming(iter(blocks), center=center, mesh=_jax_mesh(), merge=merge)
    assert n == jn
    np.testing.assert_allclose(mean, jmean, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(cov, jc, rtol=1e-12, atol=1e-12)


def test_process_local_refusals_match_the_reference(cpu_platform):
    from spark_rapids_ml_tpu.parallel.distributed import (
        streaming_covariance_process_local as jax_streaming,
    )

    for kwargs in (dict(merge="tree"), dict(merge="psum", precision="dd")):
        with pytest.raises(ValueError) as ours:
            tdist.streaming_covariance_process_local(iter([np.ones((3, 2))]), **kwargs)
        with pytest.raises(ValueError) as theirs:
            jax_streaming(iter([np.ones((3, 2))]), **kwargs)
        assert str(ours.value) == str(theirs.value)
    for fn in (tdist.streaming_covariance_process_local, jax_streaming):
        with pytest.raises(ValueError, match="no process contributed any blocks"):
            fn(iter([]))


def test_process_local_placement_in_one_process(cpu_platform):
    from spark_rapids_ml_tpu.parallel import distributed as jdist

    x = dataset()[0]
    mesh = tdist.global_mesh()
    ours = tdist.shard_rows_process_local([x[:50], x[50:]], mesh)
    jx, jm, jn, jd = jdist.shard_rows_process_local([x[:50], x[50:]], _jax_mesh())
    assert (ours.n, ours.d) == (jn, jd)
    np.testing.assert_array_equal(ours.numpy()[0][:N], np.asarray(jx)[:N])
    vec = tdist.shard_vector_process_local(np.arange(N), mesh, ours.n_pad)
    np.testing.assert_array_equal(torch.cat(vec).numpy()[:N], np.arange(N))
    assert tdist.allgather_host_max(5) == jdist.allgather_host_max(5) == 5
    counts, d = tdist._allgather_counts_and_width(N, D)
    assert (list(counts), d) == ([N], D)
    a = torch.ones(2)
    assert tdist.replicate_for_host(mesh, a) is a


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])
