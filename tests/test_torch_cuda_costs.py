"""The cost ledger and the autotuner on the card (``observability/costs.py``,
``observability/autotune.py``).

These tests need the card: they are marked ``cuda`` and skip without one.
They import nothing of JAX, so on a machine with a card and no JAX they run
with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda_costs.py``.

- A captured program's entry: temp bytes measured into its graph's pool,
  ``measured_request_bytes`` between the output bytes and the pool's
  reserved bytes, walls from CUDA events, replays bitwise with the ledger
  off and on, no synchronize on the serving path (event pairs resolve
  later, and all of them at a snapshot).
- A K1 PCA fit under the ledger: bitwise the unledgered fit, one launch,
  the Gram's entry counted as K1's work with a device-time wall.
- Host column means grow the peak by the placed block, no more.
- The HBM sampler reads the caching allocator of the card in use.
- A ladder rung on the card: bitwise the eager kernel at the rung.
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.core import serving
from spark_rapids_ml_tpu_torch.models.kmeans import KMeansModel, _assign_kernel
from spark_rapids_ml_tpu_torch.models.pca import PCAModel
from spark_rapids_ml_tpu_torch.observability import autotune, costs

pytestmark = pytest.mark.cuda

D = 64


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    port_device.set_platform("cuda")
    port_device.use_ieee_fp32_matmul()
    serving.clear_program_cache()
    monkeypatch.setenv("TPUML_COST_LEDGER", "1")
    costs.reset_for_tests()
    yield torch.device("cuda")
    monkeypatch.delenv("TPUML_COST_LEDGER")
    monkeypatch.delenv("TPUML_AUTOTUNE", raising=False)
    costs.reset_for_tests()
    autotune.reset_for_tests()
    serving.clear_program_cache()


def _pool_reserved(prog) -> int:
    pool = tuple(prog.graph.pool())
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot() if tuple(s.get("segment_pool_id") or ()) == pool)


def test_a_capture_is_measured_into_its_pool(cuda):
    rng = np.random.default_rng(0)
    model = PCAModel("c-pca", np.linalg.qr(rng.normal(size=(D, 8)))[0], np.full(8, 0.125))
    x = torch.randn((300, D), device=cuda)
    ledgered = model.transform(x)
    costs.configure(enable=False)
    plain = model.transform(x)
    costs.configure(enable=True)
    assert torch.equal(plain, ledgered)
    serving.clear_program_cache()
    costs.reset_for_tests()
    model.transform(x)
    (prog,) = serving._PROGRAMS.values()
    weights = (model._pc_device(torch.float32, cuda),)
    doc = costs.ledger_snapshot()  # resolves the replay's pending event pair
    assert costs.validate_ledger(doc) == []
    (entry,) = [e for e in doc["entries"] if e["family"] == "pca.transform"]
    assert entry["unavailable"] == [] and entry["output_bytes"] == 512 * 8 * 4
    mrb = costs.measured_request_bytes(prog.fn, prog.static, 512, D, torch.float32, weights)
    assert entry["output_bytes"] <= mrb <= _pool_reserved(prog)
    assert entry["invocations"] == 1 and entry["wall_seconds"] > 0
    assert entry["flops"] == 2 * 512 * D * 8


def test_walls_resolve_without_a_synchronize_on_the_path(cuda, monkeypatch):
    rng = np.random.default_rng(1)
    model = KMeansModel("c-km", rng.normal(size=(16, D)) * 5.0)
    x = torch.randn((100, D), device=cuda)
    model.predict(x)
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: syncs.append(1) or real(*a, **k))
    for _ in range(50):
        model.predict(x)
    assert syncs == []
    monkeypatch.setattr(torch.cuda, "synchronize", real)
    doc = costs.ledger_snapshot()
    (entry,) = [e for e in doc["entries"] if e["family"] == "kmeans.predict"]
    assert entry["invocations"] == 51 and 0 < entry["wall_seconds"] / 51 < 0.01
    assert entry["rows_served"] == 51 * 100


def test_a_k1_fit_under_the_ledger(cuda):
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.ops.kernels import covariance as k1

    x = torch.randn((20_000, 96), device=cuda)
    est = PCA().setK(4).setCovarianceBackend("pallas")
    costs.configure(enable=False)
    plain = est.fit(x)
    costs.configure(enable=True)
    k1.reset_launches()
    model = est.fit(x)
    assert k1.launches == 1
    assert np.array_equal(model.pc, plain.pc) and np.array_equal(model.explainedVariance, plain.explainedVariance)
    (row,) = [r for r in model.fit_report().costs if r["family"] == "covariance.gram"]
    assert row["flops"] == k1.cost(20_000, 96, torch.float32)["flops"] and row["invocations"] == 1
    assert row["wall_seconds"] > 0


def test_mean_center_grows_the_peak_by_at_most_the_placed_block(cuda, monkeypatch):
    """Host column means fold each placed partition with no (n, d)
    temporary: past its placement (the ``ingest H2D`` span, the block
    itself) the fold grows the peak by at most the placed block (the
    unfused fold grew it by two blocks); the means are float64's."""
    from spark_rapids_ml_tpu_torch.linalg import row_matrix

    placed = []

    def place_and_mark(*args, **kwargs):
        blk = place_array(*args, **kwargs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # the fold's growth is measured from here
        placed.append((blk.numel() * blk.element_size(), torch.cuda.memory_allocated()))
        return blk

    place_array = row_matrix.place_array
    monkeypatch.setattr(row_matrix, "place_array", place_and_mark)
    host = np.random.default_rng(6).normal(size=(524_288, 256)).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mean = row_matrix.RowMatrix([host]).column_means()
    torch.cuda.synchronize()
    (block, after_placement), = placed
    grew = torch.cuda.max_memory_allocated() - after_placement
    assert mean.is_cuda and mean.dtype == torch.float64 and block == host.size * 8
    assert grew <= block, (grew, block)
    np.testing.assert_allclose(mean.cpu().numpy(), host.mean(axis=0, dtype=np.float64), rtol=0, atol=1e-12)


def test_the_sampler_reads_the_card(cuda):
    keep = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    stats = costs._default_hbm_stats()
    index = str(torch.cuda.current_device())
    assert stats[index]["bytes_in_use"] >= keep.numel()
    assert stats[index]["peak_bytes_in_use"] >= stats[index]["bytes_in_use"]


def test_a_rung_on_the_card_is_bitwise_the_eager_kernel(cuda, monkeypatch, tmp_path):
    monkeypatch.setenv("TPUML_AUTOTUNE", "on")
    monkeypatch.setenv("TPUML_AUTOTUNE_HOT_MIN", "2")
    monkeypatch.setenv("TPUML_TUNE_STORE", str(tmp_path / "t.json"))
    monkeypatch.setenv("TPUML_PRECISION_SERVING", "f32")
    autotune.reset_for_tests()
    rng = np.random.default_rng(2)
    model = KMeansModel("c-rung", rng.normal(size=(16, D)) * 5.0)
    x = torch.randn((12, D), device=cuda) * 5.0
    outs = [model.predict(x) for _ in range(4)]
    assert autotune.active().peek_serving_bucket("kmeans.predict", D, 12, 16) == 12
    eager = _assign_kernel(x, model._centers_on(cuda, torch.float32), cosine=False,
                           precision=model._serving_precision())
    for out in outs[1:]:  # the second sighting admitted the rung
        assert torch.equal(out, eager)
