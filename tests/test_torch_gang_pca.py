"""PCA on K1 in a gang: each member's resident tensor, one all-reduce of
the moments (``linalg/row_matrix.py::_covariance_gang_local``).

This file is its own worker: ``python tests/test_torch_gang_pca.py WORLD
PORT OUT`` joins a gloo gang of WORLD ranks at ``127.0.0.1:PORT`` (rank
and world size from the environment ``member_env`` builds), fits every
case of :data:`CASES` on its own rows as a CPU tensor and writes the
results to ``OUT.<rank>.npz``. One module fixture spawns a gang of 2 and
one of 4 (each with its own timeout); the tests check that the members
return the same bits and hold them to a plain float64 PCA of all the
rows, written here in numpy (the JAX package has no pallas route on a
mesh to compare with). K1's plain version runs on the CPU.

Tolerances, components up to each column's sign and ratios absolute:
1e-10 in float64 (the merge and the plain PCA differ only in the order
of float64 sums over a few hundred rows of a well-conditioned 12-wide
covariance, ~1e-14) and 1e-5 in float32 (each member's Gram and mean are
float32 sums, relative error ~1e-7 times a few hundred rows, over an
eigengap of ~25 %).

The one-process route is held apart: a pallas fit without a gang calls K1
once, merges nothing, and equals, bit for bit, the mean, K1 and eigensolve
composed as that route composes them.
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

D, K = 12, 3
TIMEOUT = 180

#: Rows per rank for each gang size and layout: uneven, one rank with a
#: single row, and (``empty``) one with none; ``even`` divides the data
#: axis, as the xla route's live tensor needs.
ROWS = {
    2: {"uneven": [700, 1], "empty": [0, 640], "even": [300, 300]},
    4: {"uneven": [500, 1, 320, 77], "empty": [410, 0, 1, 250], "even": [160, 160, 160, 160]},
}

#: case -> (layout, dtype, covarianceBackend, meanCentering)
CASES = {
    "pallas_f32": ("uneven", np.float32, "pallas", True),
    "pallas_f64": ("uneven", np.float64, "pallas", True),
    "pallas_f64_empty_rank": ("empty", np.float64, "pallas", True),
    "pallas_f32_empty_rank": ("empty", np.float32, "pallas", True),
    "pallas_f64_uncentred": ("uneven", np.float64, "pallas", False),
    "xla_f64": ("even", np.float64, "xla", True),
}


def all_rows(world: int, layout: str) -> list:
    """Every rank's rows: a planted spectrum, and a column offset of its
    own per rank, so that the merge's between-rank term matters."""
    rng = np.random.default_rng(2029)
    scale = np.linspace(4.0, 1.0, D)
    q, _ = np.linalg.qr(rng.normal(size=(D, D)))
    out = []
    for r, n in enumerate(ROWS[world][layout]):
        z = rng.normal(size=(n, D)) * scale
        out.append(z @ q.T + 3.0 + 1.5 * r * np.arange(D) / D)
    return out


# --- the worker -----------------------------------------------------------


def _worker(world: int, port: int, out: str) -> None:
    import spark_rapids_ml_tpu_torch.linalg.row_matrix as row_matrix
    from spark_rapids_ml_tpu_torch.feature import PCA

    port_device.set_platform("cpu")
    tdist.initialize(coordinator_address=f"127.0.0.1:{port}")
    rank = tdist.process_index()
    k1_calls = []
    gram = row_matrix.centered_gram_cuda
    row_matrix.centered_gram_cuda = lambda x, mean: k1_calls.append(1) or gram(x, mean)
    res = {}
    for case, (layout, dtype, backend, center) in CASES.items():
        x = torch.from_numpy(all_rows(world, layout)[rank].astype(dtype))
        del k1_calls[:]
        model = (PCA().setDeployMode("gang").setK(K).setCovarianceBackend(backend)
                 .setMeanCentering(center).fit(x))
        counters = model.fit_report().counters
        res[f"{case}.pc"], res[f"{case}.ev"] = model.pc, model.explainedVariance
        res[f"{case}.k1"] = np.asarray(len(k1_calls))
        res[f"{case}.merges"] = np.asarray(counters.get("gang.merge.calls", 0))
        res[f"{case}.merge_bytes"] = np.asarray(counters.get("gang.merge.bytes", 0))
        res[f"{case}.count_syncs"] = np.asarray(counters.get("sync.pca.gang.counts", 0))
    np.savez(f"{out}.{rank}.npz", **res)
    print(f"OK rank {rank}/{tdist.process_count()}", flush=True)


# --- spawning -------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_gang(world: int, tmp: Path) -> list:
    port = _free_port()
    out = str(tmp / f"gang{world}")
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(world), str(port), out],
            env=tdist.member_env(rank, world, base={**os.environ, "JAX_PLATFORMS": "cpu"}),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(REPO),
        )
        for rank in range(world)
    ]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{stderr[-3000:]}"
        assert f"OK rank {rank}/{world}" in stdout, stdout
    return [dict(np.load(f"{out}.{rank}.npz")) for rank in range(world)]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gang_pca")
    return {world: _run_gang(world, tmp) for world in ROWS}


def plain_pca(x: np.ndarray, center: bool):
    """Textbook PCA in float64: mean, (centred) Gram over n − 1, eigh, the
    top K with their eigenvalues over the trace."""
    b = x - x.mean(axis=0) if center else x
    cov = b.T @ b / (x.shape[0] - 1)
    w, v = np.linalg.eigh(cov)
    return v[:, ::-1][:, :K], np.clip(w[::-1][:K], 0, None) / np.trace(cov)


# --- tests ----------------------------------------------------------------


@pytest.mark.parametrize("world", sorted(ROWS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_member_returns_the_same_bits(gangs, world, case):
    results = gangs[world]
    for rank in range(1, world):
        for field in ("pc", "ev"):
            np.testing.assert_array_equal(results[rank][f"{case}.{field}"], results[0][f"{case}.{field}"],
                                          err_msg=f"rank {rank} {field}")


@pytest.mark.parametrize("world", sorted(ROWS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_gang_fit_is_the_plain_pca_of_all_rows(gangs, world, case):
    layout, dtype, _, center = CASES[case]
    x = np.concatenate([r.astype(dtype).astype(np.float64) for r in all_rows(world, layout)])
    want_pc, want_ev = plain_pca(x, center)
    got = gangs[world][0]
    tol = 1e-10 if dtype == np.float64 else 1e-5
    pc = got[f"{case}.pc"]
    assert pc.shape == want_pc.shape
    signs = np.where(np.sum(pc * want_pc, axis=0) < 0, -1.0, 1.0)
    np.testing.assert_allclose(pc * signs, want_pc, rtol=0, atol=tol)
    np.testing.assert_allclose(got[f"{case}.ev"], want_ev, rtol=0, atol=tol)


@pytest.mark.parametrize("world", sorted(ROWS))
def test_pallas_members_run_k1_once_and_merge_once(gangs, world):
    for rank, res in enumerate(gangs[world]):
        for case, (layout, _, backend, _) in CASES.items():
            if backend != "pallas":
                continue
            has_rows = ROWS[world][layout][rank] > 0
            assert int(res[f"{case}.k1"]) == int(has_rows), (rank, case)
            assert int(res[f"{case}.merges"]) == 1, (rank, case)
            assert int(res[f"{case}.count_syncs"]) == 1, (rank, case)
            # The shifts' slots and [gram | sum], all float64.
            assert int(res[f"{case}.merge_bytes"]) == 8 * (world * D + D * D + D), (rank, case)


@pytest.mark.parametrize("world", sorted(ROWS))
def test_the_xla_gang_route_fits_as_before(gangs, world):
    """The default route keeps its host round trip and its mesh covariance:
    no K1 and no moments merge."""
    for res in gangs[world]:
        assert int(res["xla_f64.k1"]) == 0
        assert int(res["xla_f64.merges"]) == 0
        assert int(res["xla_f64.count_syncs"]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_one_process_pallas_route_is_unchanged(monkeypatch, dtype):
    import spark_rapids_ml_tpu_torch.linalg.row_matrix as row_matrix
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.ops.eigh import auto_max_iters, eigh_auto
    from spark_rapids_ml_tpu_torch.ops.kernels.covariance import centered_gram_plain

    port_device.set_platform("cpu")
    x = torch.from_numpy(np.concatenate(all_rows(2, "uneven"))).to(dtype)
    calls = []
    gram = row_matrix.centered_gram_cuda
    monkeypatch.setattr(row_matrix, "centered_gram_cuda", lambda a, m: calls.append(1) or gram(a, m))
    model = PCA().setK(K).setCovarianceBackend("pallas").fit(x)
    counters = model.fit_report().counters
    assert calls == [1]
    assert "gang.merge.calls" not in counters and "sync.pca.gang.counts" not in counters
    cov = centered_gram_plain(x, torch.mean(x, dim=0)) / (x.shape[0] - 1)
    w, v, _ = eigh_auto(cov, K, max_iters=auto_max_iters(PCA().getEigenIters()))
    np.testing.assert_array_equal(model.pc, v.double().numpy())
    want_ev = np.clip(w.numpy(), 0, None) / float(torch.trace(cov))
    np.testing.assert_array_equal(model.explainedVariance, want_ev.astype(np.float64))


def test_pallas_refuses_a_mesh_outside_a_gang():
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh

    port_device.set_platform("cpu")
    mesh = make_mesh((2, 1), devices=[torch.device("cpu")] * 2)
    x = torch.from_numpy(np.concatenate(all_rows(2, "even")))
    with pytest.raises(ValueError, match="covarianceBackend='pallas' applies"):
        PCA(mesh=mesh).setK(K).setCovarianceBackend("pallas").fit(x)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
