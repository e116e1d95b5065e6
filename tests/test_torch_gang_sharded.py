"""The five sharded families in a 2-rank gloo gang on the CPU: kNN, ANN,
the UMAP layout, DBSCAN and the forests, each rank fitting the whole
matrix (the reference's contract: every process passes the same rows).

This file is its own worker: ``python tests/test_torch_gang_sharded.py
torch PORT OUT`` joins a 2-rank gloo gang at ``127.0.0.1:PORT`` (rank and
world size from the environment ``member_env`` builds), reads the inputs
the test drew with JAX from ``OUT.inputs.npz``, fits every family and
writes ``OUT.<rank>.npz``. One module-scoped fixture spawns the gang once
(``TIMEOUT`` seconds); the cases then hold, for each family:

  - the two ranks bitwise equal;
  - each rank bitwise the port's one-process fit on a (2, 1) mesh of one
    repeated CPU device (the same estimators and ops, here);
  - the JAX package's one-process fit on its (2, 1) mesh, at the
    tolerances of ``test_torch_mesh_neighbours.py``: kNN, ANN ``brute``
    and DBSCAN indices, labels and core masks exact, distances 1e-10
    (float64); the UMAP sharded epoch 1e-5 of JAX's with JAX's draws
    passed in (pooled and per-edge); gini forests bitwise and variance
    forests (leaves 1e-5, gains 1e-4, structure exact) with JAX's edges,
    weights and uniforms passed in.

ANN's IVF builds (``ivfflat``, ``ivfpq``) and mesh IVF search refuse a
gang: the reference's own fail there (``python
tests/test_torch_gang_sharded.py jax PORT OUT`` is the reference's gang,
run by the ``slow``-marked probe below, which shows its four other
families completing bitwise its one-process (2, 1) mesh fit and its IVF
routes failing).

The same gang also holds the other contract: a PCA (and a ``RowMatrix``
covariance) on a member's tensor reads it as that member's local rows, as
``core/ingest.py`` does, so the gang fits both ranks' rows together. The
in-process cases hold the data-axis gather outside a gang, its refusal of
a width it cannot move, and the mesh whose ``processes`` disagrees with
the gang.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from spark_rapids_ml_tpu_torch import device as port_device  # noqa: E402
from spark_rapids_ml_tpu_torch.parallel import distributed as tdist  # noqa: E402

N, D, NQ = 203, 7, 20
WORLD = 2
TIMEOUT = 240
FAMILIES = ["nearest_neighbors", "ann", "umap", "dbscan", "random_forest"]
GATHER_DTYPES = ["float16", "bfloat16", "float32", "float64", "int16", "int32", "int64", "bool"]
PCA_ROWS = [(0, 102), (102, 202)]  # each rank's local rows for the PCA on a tensor
LAYOUT = dict(neg_rate=3, learning_rate=1.0, repulsion=1.0, a=1.577, b=0.895)
UM_K, UM_POOL = 6, 16
UM_EPOCHS = {UM_POOL: 1, 0: 2}  # pooled: one epoch from a grid, as test_torch_mesh_neighbours
RF = dict(max_depth=3, n_bins=8, feat_subset=4)


def dataset():
    rng = np.random.default_rng(515)
    x = rng.normal(size=(N, D)) * np.linspace(1.0, 2.5, D) + 2.0
    x[:60] += 5.0
    y_bin = (x[:, 0] - x[:, 3] + 0.4 * rng.normal(size=N) > 2.0).astype(np.float64)
    y_lin = x @ rng.normal(size=D) + 0.1 * rng.normal(size=N)
    return x, y_bin, y_lin


def queries():
    return dataset()[0][:NQ] + 0.05


_INT_OF_WIDTH = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def gather_block(dtype: str, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block for the gather check: -0.0, ±inf and a NaN
    with a payload for the floats, extreme values for the integers."""
    if dtype == "bool":
        return torch.tensor([True, False, rank == 1])
    tdt = getattr(torch, dtype)
    if not tdt.is_floating_point:
        info = torch.iinfo(tdt)
        return torch.tensor([info.min, -1, rank, info.max], dtype=tdt)
    block = torch.tensor([-0.0, float("inf"), float("-inf"), float("nan"), rank + 0.5], dtype=tdt)
    block.view(_INT_OF_WIDTH[block.element_size()])[3] |= 3
    return block


def tensor_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as a numpy array (floats as integers of their width)."""
    return (t.view(_INT_OF_WIDTH[t.element_size()]) if t.is_floating_point() else t).numpy()


# --- the port's fits, in a gang or on a one-process mesh ----------------------


def estimator_fits(setup) -> dict:
    """Every family's estimator fit on the whole matrix, its estimator set
    up by ``setup`` (the gang's deploy mode, or a one-process mesh): a
    dict of arrays keyed ``family/what``."""
    from spark_rapids_ml_tpu_torch.classification import RandomForestClassifier
    from spark_rapids_ml_tpu_torch.clustering import DBSCAN
    from spark_rapids_ml_tpu_torch.manifold import UMAP
    from spark_rapids_ml_tpu_torch.neighbors import ApproximateNearestNeighbors, NearestNeighbors
    from spark_rapids_ml_tpu_torch.regression import RandomForestRegressor

    x, y_bin, y_lin = dataset()
    xt, q = torch.from_numpy(x), torch.from_numpy(queries())
    out = {}
    for metric in ("euclidean", "cosine"):
        d, idx = setup(NearestNeighbors().setK(4).setMetric(metric)).fit(xt).kneighbors(q)
        out[f"nearest_neighbors/{metric}_d"], out[f"nearest_neighbors/{metric}_i"] = d.numpy(), idx.numpy()
    for algo in ("brute", "brute_approx"):
        d, idx = setup(ApproximateNearestNeighbors().setK(4).setAlgorithm(algo)).fit(xt).kneighbors(q)
        out[f"ann/{algo}_d"], out[f"ann/{algo}_i"] = d.numpy(), idx.numpy()
    for algo in ("ivfflat", "ivfpq"):
        params = {"nlist": 6, "nprobe": 2, "M": 7, "n_bits": 5} if algo == "ivfpq" else {"nlist": 6, "nprobe": 2}
        est = ApproximateNearestNeighbors().setK(4).setAlgorithm(algo).setAlgoParams(params)
        try:
            setup(est).fit(x)
            out[f"ann/{algo}_refusal"] = np.asarray("fitted")
        except NotImplementedError as exc:
            out[f"ann/{algo}_refusal"] = np.asarray(str(exc))
    for pool in (UM_POOL, 0):
        est = UMAP().setNNeighbors(UM_K).setNEpochs(20).setNegativePoolSize(pool).setSeed(0)
        out[f"umap/pool{pool}"] = setup(est).fit(x).embedding
    model = setup(DBSCAN().setEps(1.2).setMinSamples(4)).fit(x)
    out["dbscan/labels"], out["dbscan/core"] = model.labels_, model.core_mask_
    clf = setup(RandomForestClassifier().setNumTrees(4).setMaxDepth(3).setSeed(1)).fit((x, y_bin))
    reg = setup(RandomForestRegressor().setNumTrees(4).setMaxDepth(3).setSeed(1)).fit((x, y_lin))
    for name, model in (("classifier", clf), ("regressor", reg)):
        for field, t in zip(model._forest._fields, model._forest):
            out[f"random_forest/{name}_{field}"] = t.numpy()
        out[f"random_forest/{name}_predict"] = model.predict(x)
    return out


def umap_graph(inputs: dict):
    from spark_rapids_ml_tpu_torch.ops import umap

    return umap.FuzzyGraph(*(torch.from_numpy(inputs[f"umap_graph_{f}"]) for f in umap.FuzzyGraph._fields))


def draw_fits(mesh, inputs: dict) -> dict:
    """The ops the JAX package is held against with its own draws passed
    in: the UMAP sharded epoch (JAX's pool, then JAX's per-shard draws of
    this process's positions) and the sharded forest growth."""
    from spark_rapids_ml_tpu_torch.ops import trees, umap
    from spark_rapids_ml_tpu_torch.parallel.mesh import data_positions

    out = {}
    for pool in (UM_POOL, 0):
        graph = umap_graph(inputs)
        if pool:
            graph = graph._replace(weight=torch.from_numpy(inputs["umap_pooled_weight"]))
        epoch, n_pad = umap._make_sharded_epoch_fn(mesh, graph, n_epochs=UM_EPOCHS[pool], neg_pool=pool, **LAYOUT)
        y = torch.nn.functional.pad(torch.from_numpy(inputs[f"umap_y0_pool{pool}"]), (0, 0, 0, n_pad - N))
        for ep in range(UM_EPOCHS[pool]):
            if pool:
                neg = torch.from_numpy(inputs[f"umap_draws_pool{pool}"][ep]).long()
            else:
                neg = [torch.from_numpy(inputs["umap_draws_pool0"][ep, g]).long() for g in data_positions(mesh)]
            y = epoch(ep, y, neg)
        out[f"umap/epoch_pool{pool}"] = y.numpy()
    for kind in ("gini", "variance"):
        args = [torch.from_numpy(inputs[f"rf_{kind}_{a}"]) for a in ("xb", "rs", "w", "edges")]
        uniforms = [torch.from_numpy(inputs[f"rf_{kind}_u{level}"]) for level in range(RF["max_depth"])]
        forest = trees.grow_forest_sharded(mesh, *args, uniforms, impurity=kind, **RF)
        for field, t in zip(forest._fields, forest):
            out[f"random_forest/ops_{kind}_{field}"] = t.numpy()
    return out


# --- the workers ----------------------------------------------------------


def _torch_worker(port: int, out: str) -> None:
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.linalg.row_matrix import RowMatrix
    from spark_rapids_ml_tpu_torch.parallel.collectives import all_gather_data
    from spark_rapids_ml_tpu_torch.utils.tracing import counter_value

    port_device.set_platform("cpu")
    tdist.initialize(coordinator_address=f"127.0.0.1:{port}")
    rank = tdist.process_index()
    inputs = dict(np.load(f"{out}.inputs.npz"))
    before = counter_value("collectives.gather.bytes")
    res = estimator_fits(lambda est: est.setDeployMode("gang"))
    res["gather_bytes"] = np.asarray(counter_value("collectives.gather.bytes") - before)
    res.update(draw_fits(tdist.global_mesh(), inputs))
    for dtype in GATHER_DTYPES:
        got = torch.stack(all_gather_data([gather_block(dtype, rank)]))
        res[f"gather/{dtype}"], res[f"gather_dtype/{dtype}"] = tensor_bits(got), np.asarray(str(got.dtype))
    lo, hi = PCA_ROWS[rank]
    local = torch.from_numpy(dataset()[0][lo:hi])
    model = PCA().setDeployMode("gang").setK(3).setEigenSolver("full").fit(local)
    res["pca/pc"], res["pca/ratio"] = model.pc, model.explainedVariance
    res["pca/cov"] = RowMatrix(local, mesh=tdist.global_mesh()).compute_covariance().numpy()
    res["mesh"] = np.asarray([tdist.global_mesh().shape["data"], tdist.global_mesh().processes])
    np.savez(f"{out}.{rank}.npz", **res)
    world = tdist.process_count()
    torch.distributed.destroy_process_group()
    print(f"OK rank {rank}/{world}")


def _jax_worker(out: str) -> None:
    """One process of the reference's gang (``multiproc_gang_fit_worker``'s
    start): the five families on the global (2, 1) mesh, each process with
    the whole matrix; a family that raises records its error."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from spark_rapids_ml_tpu.parallel import distributed as jdist

    jdist.initialize()
    res = jax_family_fits(jdist.global_mesh())
    np.savez(f"{out}.{jax.process_index()}.npz", **res)
    print(f"OK process {jax.process_index()}/{jax.process_count()}")


def jax_family_fits(mesh) -> dict:
    """The reference's estimator fits of the five families on ``mesh``,
    each family's arrays or its error."""
    from spark_rapids_ml_tpu.classification import RandomForestClassifier
    from spark_rapids_ml_tpu.clustering import DBSCAN
    from spark_rapids_ml_tpu.manifold import UMAP
    from spark_rapids_ml_tpu.neighbors import ApproximateNearestNeighbors, NearestNeighbors

    x, y_bin, _ = dataset()
    q = queries()
    ivf = {"nlist": 6, "nprobe": 2}

    def ivfflat_fit():
        return ApproximateNearestNeighbors(mesh=mesh).setK(4).setAlgoParams(ivf).fit(x).kneighbors(q)

    def ivfflat_search():
        return ApproximateNearestNeighbors().setK(4).setAlgoParams(ivf).fit(x).setMesh(mesh).kneighbors(q)

    def ivfpq_fit():
        est = ApproximateNearestNeighbors(mesh=mesh).setK(4).setAlgorithm("ivfpq")
        return est.setAlgoParams({**ivf, "M": 7, "n_bits": 5}).fit(x).kneighbors(q)

    def dbscan():
        model = DBSCAN(mesh=mesh).setEps(1.2).setMinSamples(4).fit(x)
        return model.labels_, model.core_mask_

    def forest():
        model = RandomForestClassifier(mesh=mesh).setNumTrees(4).setMaxDepth(3).setSeed(1).fit((x, y_bin))
        return (model.predict(x),) + tuple(np.asarray(t) for t in model._forest)

    fits = {
        "nearest_neighbors": lambda: NearestNeighbors(mesh=mesh).setK(4).fit(x).kneighbors(q),
        "ann_brute": lambda: ApproximateNearestNeighbors(mesh=mesh).setK(4).setAlgorithm("brute").fit(x).kneighbors(q),
        "ann_ivfflat_fit": ivfflat_fit,
        "ann_ivfflat_search": ivfflat_search,
        "ann_ivfpq_fit": ivfpq_fit,
        "umap": lambda: (UMAP(mesh=mesh).setNNeighbors(UM_K).setNEpochs(20).setSeed(0).fit(x).embedding,),
        "dbscan": dbscan,
        "random_forest": forest,
    }
    res = {}
    for name, fit in fits.items():
        try:
            for i, a in enumerate(fit()):
                res[f"{name}/{i}"] = np.asarray(a)
        except Exception as exc:  # the record: which of the reference's routes fail in a gang
            res[f"{name}/error"] = np.asarray(f"{type(exc).__name__}: {exc}"[:400])
    return res


# --- spawning -------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(kind: str, out: str) -> list:
    """Start both ranks of ``kind``'s gang, wait under ``TIMEOUT`` and
    return each rank's results."""
    port = _free_port()
    base = {**os.environ, "JAX_PLATFORMS": "cpu"}
    if kind == "jax":
        base.update({"XLA_FLAGS": "--xla_force_host_platform_device_count=1", "JAX_ENABLE_X64": "1",
                     "TPUML_COORDINATOR": f"127.0.0.1:{port}"})
    procs = []
    for rank in range(WORLD):
        env = tdist.member_env(rank, WORLD, base=base)
        if kind == "jax":
            env["TPUML_COORDINATOR"] = f"127.0.0.1:{port}"
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), kind, str(port), out],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                      cwd=str(REPO)))
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{kind} rank {rank} failed:\n{stderr[-3000:]}"
        assert f"rank {rank}/{WORLD}" in stdout or f"process {rank}/{WORLD}" in stdout, stdout
    return [dict(np.load(f"{out}.{rank}.npz")) for rank in range(WORLD)]


def _jax_mesh():
    import jax

    from spark_rapids_ml_tpu.parallel.mesh import make_mesh

    return make_mesh((2, 1), devices=jax.devices()[:2])


def _umap_inputs() -> dict:
    """JAX's fuzzy graph of the rows, start layouts, its pool per epoch and
    its per-shard per-edge draws for a data axis of 2 (pooled: a jittered
    grid start, the drawn rows weighing 0, as ``test_torch_mesh_neighbours``
    holds the pooled epoch)."""
    import jax
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.models.umap import _knn_excluding_self as jax_excluding_self
    from spark_rapids_ml_tpu.ops import umap as jax_umap

    x = dataset()[0].astype(np.float32)
    jd, ji = jax_excluding_self(jnp.asarray(x), UM_K, "euclidean")
    graph = jax_umap.fuzzy_simplicial_set(ji, jd)
    inputs = {f"umap_graph_{f}": np.array(a) for f, a in zip(graph._fields, graph)}
    key = jax.random.key(5)
    k_pool = key
    pools = []
    for _ in range(UM_EPOCHS[UM_POOL]):
        k_pool, k_neg = jax.random.split(k_pool)
        pools.append(np.array(jax.random.randint(k_neg, (UM_POOL,), 0, N)))
    n_local = -(-N // WORLD)
    keys = [jax.random.fold_in(key, i) for i in range(WORLD)]
    per_edge = []
    for _ in range(UM_EPOCHS[0]):
        epoch = []
        for i in range(WORLD):
            keys[i], k_neg = jax.random.split(keys[i])
            draw = jax.random.randint(k_neg, (n_local, UM_K, LAYOUT["neg_rate"]), 0, N)
            epoch.append(np.array(draw).reshape(n_local * UM_K, -1))
        per_edge.append(np.stack(epoch))
    rng = np.random.default_rng(N)
    side = int(np.ceil(np.sqrt(N)))
    cells = np.stack(np.meshgrid(np.arange(side), np.arange(side)), axis=-1).reshape(-1, 2)[:N]
    grid = ((cells - (side - 1) / 2.0) * 1.5 + rng.uniform(-0.2, 0.2, size=(N, 2)))[rng.permutation(N)]
    weight = np.array(graph.weight)
    weight[np.unique(np.concatenate(pools))] = 0.0
    inputs.update({
        f"umap_draws_pool{UM_POOL}": np.stack(pools), "umap_draws_pool0": np.stack(per_edge),
        f"umap_y0_pool{UM_POOL}": grid.astype(np.float32), "umap_pooled_weight": weight,
        "umap_y0_pool0": rng.uniform(-10, 10, size=(N, 2)).astype(np.float32),
    })
    return inputs


def _forest_inputs() -> dict:
    """JAX's quantile edges, bins, bootstrap weights and per-level
    uniforms for a gini and a variance forest of 4 trees."""
    import jax
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.ops import trees as jax_trees

    rng = np.random.default_rng(9)
    x = rng.normal(size=(N, 6)).astype(np.float32)
    inputs = {}
    for kind in ("gini", "variance"):
        if kind == "variance":
            y = (2 * x[:, 0] - x[:, 2] + 0.1 * rng.normal(size=N)).astype(np.float32)
            yc = y - y.mean()
            rs = np.stack([np.ones_like(yc), yc, yc * yc], 1).astype(np.float32)
        else:
            rs = np.eye(2, dtype=np.float32)[(x[:, 0] + 0.5 * x[:, 1] > 0).astype(int)]
        k_sample, k_feat = jax.random.split(jax.random.key(N))
        edges = jax_trees.quantize_features(jnp.asarray(x), RF["n_bins"])
        inputs.update({
            f"rf_{kind}_xb": np.array(jax_trees.bin_features(jnp.asarray(x), edges)),
            f"rf_{kind}_rs": rs,
            f"rf_{kind}_w": np.array(jax_trees.sample_weights(k_sample, 4, N, 1.0, True)),
            f"rf_{kind}_edges": np.array(edges).astype(np.float32),
        })
        for level in range(RF["max_depth"]):
            u = jax.random.uniform(jax.random.fold_in(k_feat, level), (4, 2 ** level, 6))
            inputs[f"rf_{kind}_u{level}"] = np.array(u)
    return inputs


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The one 2-rank gang of this module and the JAX inputs it ran on."""
    out = str(tmp_path_factory.mktemp("gang") / "sharded")
    inputs = {**_umap_inputs(), **_forest_inputs()}
    np.savez(f"{out}.inputs.npz", **inputs)
    return _spawn("torch", out), inputs


# --- the references -------------------------------------------------------


@pytest.fixture(scope="module")
def port_one_process(gang):
    """The port's fits on a one-process (2, 1) mesh of one repeated CPU
    device, on the inputs the gang ran on."""
    from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh

    platform = port_device.get_platform()
    port_device.set_platform("cpu")
    try:
        mesh = make_mesh((2, 1), devices=[torch.device("cpu")] * 2)
        return {**estimator_fits(lambda est: est.setMesh(mesh)), **draw_fits(mesh, gang[1])}
    finally:
        port_device.set_platform(platform)


def _family_keys(results: dict, family: str) -> list:
    keys = sorted(k for k in results if k.startswith(family + "/"))
    assert keys, family
    return keys


def _bits(a: np.ndarray) -> np.ndarray:
    """An array's bits (floats as unsigned integers of their width)."""
    a = np.asarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}")) if a.dtype.kind == "f" else a


@pytest.mark.parametrize("family", FAMILIES)
def test_the_ranks_are_bitwise_equal(gang, family):
    ranks = gang[0]
    assert ranks[0].keys() == ranks[1].keys()
    for key in _family_keys(ranks[0], family):
        assert np.array_equal(_bits(ranks[0][key]), _bits(ranks[1][key])), key
    assert ranks[0]["mesh"].tolist() == ranks[1]["mesh"].tolist() == [WORLD, WORLD]


@pytest.mark.parametrize("family", FAMILIES)
def test_the_gang_is_the_one_process_2x1_mesh_fit(gang, port_one_process, family):
    """Every result but the IVF refusals, which a one-process mesh fits."""
    got = gang[0][0]
    keys = _family_keys(got, family)
    assert keys == _family_keys(port_one_process, family)
    for key in (k for k in keys if not k.endswith("_refusal")):
        assert np.array_equal(_bits(got[key]), _bits(port_one_process[key])), key


def _hold(name, d, idx, want, rtol=1e-10):
    wd, wi = (np.asarray(a) for a in want)
    assert np.array_equal(idx, wi), f"{name}: indices differ in {np.sum(idx != wi)} places"
    np.testing.assert_allclose(d, wd, rtol=rtol, atol=rtol * 1e-2, err_msg=name)


def _jax_holds_nearest_neighbors(got, inputs):
    from spark_rapids_ml_tpu.neighbors import NearestNeighbors as JaxNN

    x = dataset()[0]
    for metric in ("euclidean", "cosine"):
        want = JaxNN(mesh=_jax_mesh()).setK(4).setMetric(metric).fit(x).kneighbors(queries())
        _hold(metric, got[f"nearest_neighbors/{metric}_d"], got[f"nearest_neighbors/{metric}_i"], want)


def _jax_holds_ann(got, inputs):
    from spark_rapids_ml_tpu.neighbors import ApproximateNearestNeighbors as JaxANN

    want = JaxANN(mesh=_jax_mesh()).setK(4).setAlgorithm("brute").fit(dataset()[0]).kneighbors(queries())
    _hold("brute", got["ann/brute_d"], got["ann/brute_i"], want)
    # brute_approx: JAX's approx_min_k has no counterpart (the port's is exact), so it
    # is held to the exact search above.
    _hold("brute_approx", got["ann/brute_approx_d"], got["ann/brute_approx_i"], want)
    for algo, what in (("ivfflat", "the mesh IVF build"), ("ivfpq", "the mesh IVF build")):
        message = str(got[f"ann/{algo}_refusal"])
        assert message.startswith(f"{what} in a gang of 2 processes is refused"), message
        assert "the reference's own route fails there" in message and "item 18" not in message


def _jax_holds_umap(got, inputs):
    import jax
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.ops import umap as jax_umap

    graph = jax_umap.FuzzyGraph(*(jnp.asarray(inputs[f"umap_graph_{f}"]) for f in jax_umap.FuzzyGraph._fields))
    for pool in (UM_POOL, 0):
        g = graph._replace(weight=jnp.asarray(inputs["umap_pooled_weight"])) if pool else graph
        want = jax_umap.optimize_layout_sharded(_jax_mesh(), jnp.asarray(inputs[f"umap_y0_pool{pool}"]), g,
                                                jax.random.key(5), n_epochs=UM_EPOCHS[pool], neg_pool=pool,
                                                **LAYOUT)
        y = got[f"umap/epoch_pool{pool}"]
        assert np.all(y[N:] == 0)
        np.testing.assert_allclose(y[:N], np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=f"pool {pool}")
    for pool in (UM_POOL, 0):
        assert np.all(np.isfinite(got[f"umap/pool{pool}"])) and got[f"umap/pool{pool}"].shape == (N, 2)


def _jax_holds_dbscan(got, inputs):
    from spark_rapids_ml_tpu.clustering import DBSCAN as JaxDBSCAN

    want = JaxDBSCAN(mesh=_jax_mesh()).setEps(1.2).setMinSamples(4).fit(dataset()[0])
    assert np.array_equal(got["dbscan/labels"], want.labels_)
    assert np.array_equal(got["dbscan/core"], want.core_mask_)


def _jax_holds_random_forest(got, inputs):
    import jax
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.ops import trees as jax_trees

    for kind in ("gini", "variance"):
        _, k_feat = jax.random.split(jax.random.key(N))
        args = [jnp.asarray(inputs[f"rf_{kind}_{a}"]) for a in ("xb", "rs", "w", "edges")]
        want = jax_trees.grow_forest_sharded(_jax_mesh(), *args, k_feat, impurity=kind, **RF)
        for field, w in zip(want._fields, want):
            g, w = got[f"random_forest/ops_{kind}_{field}"], np.asarray(w)
            if kind == "gini" or field in ("feature", "threshold", "is_leaf"):
                assert np.array_equal(g, w), (kind, field)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=f"{kind} {field}")


@pytest.mark.parametrize("family", FAMILIES)
def test_the_gang_is_within_the_family_tolerance_of_the_jax_mesh_fit(gang, family):
    ranks, inputs = gang
    globals()[f"_jax_holds_{family}"](ranks[0], inputs)


@pytest.mark.parametrize("dtype", GATHER_DTYPES)
def test_the_gang_gathers_every_shard_bit_for_bit(gang, dtype):
    want = torch.stack([gather_block(dtype, rank) for rank in range(WORLD)])
    for res in gang[0]:
        assert str(res[f"gather_dtype/{dtype}"]) == str(want.dtype), dtype
        assert np.array_equal(res[f"gather/{dtype}"], tensor_bits(want)), (dtype, res[f"gather/{dtype}"])
    assert int(gang[0][0]["gather_bytes"]) == int(gang[0][1]["gather_bytes"]) > 0


def test_a_gang_pca_on_tensors_fits_both_ranks_local_rows(gang):
    """A member's tensor is its local rows (``core/ingest.py``'s contract),
    not the whole matrix the five families take: the gang's PCA and
    ``RowMatrix`` covariance are the one-process fit of both ranks' rows
    (components 1e-10 up to sign, ratios 1e-10, covariance 1e-12)."""
    from spark_rapids_ml_tpu.utils.testing import assert_components_close
    from spark_rapids_ml_tpu_torch.feature import PCA

    ranks = gang[0]
    for key in _family_keys(ranks[0], "pca"):
        assert np.array_equal(_bits(ranks[0][key]), _bits(ranks[1][key])), key
    rows = dataset()[0][PCA_ROWS[0][0]:PCA_ROWS[-1][1]]
    platform = port_device.get_platform()
    port_device.set_platform("cpu")
    try:
        want = PCA().setK(3).setEigenSolver("full").fit(torch.from_numpy(rows))
    finally:
        port_device.set_platform(platform)
    assert_components_close(ranks[0]["pca/pc"], want.pc, 1e-10)
    np.testing.assert_allclose(ranks[0]["pca/ratio"], want.explainedVariance, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ranks[0]["pca/cov"], np.cov(rows.T), rtol=0, atol=1e-12)


# --- in process -----------------------------------------------------------


@pytest.mark.parametrize("dtype", GATHER_DTYPES)
def test_the_gather_is_the_blocks_outside_a_gang(dtype):
    from spark_rapids_ml_tpu_torch.parallel.collectives import all_gather_data
    from spark_rapids_ml_tpu_torch.utils.tracing import counter_value

    blocks = [gather_block(dtype, rank) for rank in range(WORLD)]
    before = counter_value("collectives.gather.bytes")
    got = all_gather_data(blocks)
    assert len(got) == WORLD and all(g is b for g, b in zip(got, blocks))
    assert counter_value("collectives.gather.bytes") == before
    with pytest.raises(ValueError, match="at least one block"):
        all_gather_data([])


def test_the_gather_refuses_a_width_it_cannot_move():
    from spark_rapids_ml_tpu_torch.parallel.collectives import all_gather_data

    with pytest.raises(ValueError, match=r"1, 2, 4 or 8 bytes; torch.complex128 has 16"):
        all_gather_data([torch.zeros(3, dtype=torch.complex128)])


def test_a_mesh_whose_processes_disagree_with_the_gang_raises():
    from spark_rapids_ml_tpu_torch.ops import knn
    from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh, data_positions, make_mesh, shard_tensor_rows

    devices = np.empty((1, 1), dtype=object)
    devices[0, 0] = torch.device("cpu")
    mesh = Mesh(devices, processes=2)
    for call in (lambda: data_positions(mesh), lambda: knn.shard_items(np.ones((4, 2)), mesh),
                 lambda: shard_tensor_rows(torch.ones(4, 2), mesh)):
        with pytest.raises(ValueError, match=r"spans 2 processes but this gang has 1"):
            call()
    assert data_positions(make_mesh((3, 1), devices=[torch.device("cpu")] * 3)) == [0, 1, 2]


@pytest.mark.slow
def test_the_reference_gang_runs_four_families_and_fails_its_ivf_routes(tmp_path):
    """Step 0's record: the reference's own 2-process gang (one virtual CPU
    device a process, the whole matrix on each) fits kNN, ANN ``brute``,
    UMAP, DBSCAN and the forest bitwise its one-process (2, 1) mesh fit,
    and fails its IVF builds (``ivfflat`` and ``ivfpq``) and its mesh IVF
    search."""
    ranks = _spawn("jax", str(tmp_path / "reference"))
    single = jax_family_fits(_jax_mesh())
    for name in ("nearest_neighbors", "ann_brute", "umap", "dbscan", "random_forest"):
        keys = _family_keys(single, name)
        assert keys == _family_keys(ranks[0], name) == _family_keys(ranks[1], name), name
        for key in keys:
            assert np.array_equal(ranks[0][key], ranks[1][key]) and np.array_equal(ranks[0][key], single[key]), key
    for name, needle in (("ann_ivfflat_fit", "addressable by the sharding"),
                         ("ann_ivfpq_fit", "addressable by the sharding"),
                         ("ann_ivfflat_search", "non-addressable")):
        assert f"{name}/error" not in single, name
        for res in ranks:
            assert needle in str(res[f"{name}/error"]), (name, res.get(f"{name}/error"))


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_worker(sys.argv[3])
    else:
        _torch_worker(int(sys.argv[2]), sys.argv[3])
