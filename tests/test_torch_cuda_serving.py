"""The program cache on a CUDA card: one captured graph per (program key,
row bucket), held against the eager kernel at the same bucket, and the
pinned double-buffered stream.

These tests need the card: they are marked ``cuda`` and skip without one.
They import nothing of JAX, so on a machine with a card and no JAX they
run without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serving.py -q

Bitwise claims hold at one bucket (cuBLAS may pick another algorithm for
another row count): a replay equals the eager kernel on the same padded
bucket bit for bit.
"""

import gc
import threading

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.core import serving
from spark_rapids_ml_tpu_torch.models.kmeans import KMeansModel
from spark_rapids_ml_tpu_torch.models.logistic_regression import LogisticRegressionModel
from spark_rapids_ml_tpu_torch.models.pca import PCAModel
from spark_rapids_ml_tpu_torch.serving import ServingRuntime
from spark_rapids_ml_tpu_torch.serving.signature import tree_leaves
from spark_rapids_ml_tpu_torch.utils.tracing import counter_value

pytestmark = pytest.mark.cuda

D = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    port_device.set_platform("cuda")
    port_device.use_ieee_fp32_matmul()
    serving.clear_program_cache()
    yield torch.device("cuda")
    serving.clear_program_cache()


def _eager_at_bucket(sig, x, weights):
    """The signature's kernel run eagerly on ``x`` zero-padded to its bucket."""
    n = x.shape[0]
    xp = torch.zeros((serving.bucket_rows(n), x.shape[1]), dtype=x.dtype, device=x.device)
    xp[:n] = x
    out = sig.kernel(xp, *weights, **sig.static)
    return [leaf[:n] for leaf in tree_leaves(out)]


def _models(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "pca": PCAModel("g-pca", np.linalg.qr(rng.normal(size=(D, 8)))[0], np.full(8, 0.125)),
        "km": KMeansModel("g-km", rng.normal(size=(20, D)) * 3.0),
        "logreg": LogisticRegressionModel("g-lg", rng.normal(size=(D, 3)), rng.normal(size=3), numClasses=3),
    }


@pytest.mark.parametrize("family", ["pca", "km", "logreg"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_capture_per_bucket_and_replay_is_the_eager_kernel(cuda, family, dtype):
    model = _models()[family]
    sig = model.serving_signature()
    weights = sig.weights_on(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    sizes = (1, 5, 8, 9, 100, 1000, 1024)
    xs = [torch.randn((n, D), generator=gen, device=cuda, dtype=dtype) for n in sizes]
    for _ in range(2):
        for x in xs:
            got = serving.serve_rows(sig.kernel, x, weights, static=sig.static, name=sig.name)
            for g, want in zip(tree_leaves(got), _eager_at_bucket(sig, x, weights)):
                assert g.device.type == "cuda" and torch.equal(g, want)
    stats = serving.program_cache_stats()
    assert stats["compiles"] == len({serving.bucket_rows(n) for n in sizes})
    assert all(prog.is_graph and prog.graph is not None for prog in serving._PROGRAMS.values())


def test_padding_never_leaks_under_cosine(cuda):
    rng = np.random.default_rng(2)
    model = KMeansModel("cos", rng.normal(size=(7, D)))
    model.set(model.distanceMeasure, "cosine")
    x = torch.tensor(rng.normal(size=(11, D)), device=cuda)
    labels = model.predict(x)
    c = torch.tensor(model.clusterCenters(), device=cuda)
    xn = x / x.norm(dim=1, keepdim=True)
    want = torch.argmax(xn @ (c / c.norm(dim=1, keepdim=True)).T, dim=1)
    assert labels.shape == (11,) and torch.equal(labels, want)


def test_entry_keeps_its_weights_alive(cuda):
    model = _models()["km"]
    x = torch.randn((3, D), device=cuda, dtype=torch.float64)
    model.predict(x)
    (prog,) = list(serving._PROGRAMS.values())
    held = tree_leaves(prog.weights)
    ptrs = {w.data_ptr() for w in held}
    model._centers_dev = None  # the model lets go; the entry does not
    del model
    gc.collect()
    assert {w.data_ptr() for w in tree_leaves(prog.weights)} == ptrs and not prog.closed


def test_retire_frees_weights_and_graphs(cuda):
    """``retire`` drops the version's device weights and closes its graphs:
    ``memory_allocated`` falls by at least their bytes."""
    rng = np.random.default_rng(3)
    model = PCAModel("big", np.linalg.qr(rng.normal(size=(4096, 16)))[0], np.full(16, 1 / 16))
    rt = ServingRuntime(max_batch=64, max_delay_ms=1.0)
    version = rt.register("pca", model, warm_buckets=(8, 64, 512)).version
    progs = [p for p in serving._PROGRAMS.values() if p.is_graph]
    assert len(progs) == 3
    held = sum(p.static_x.numel() * p.static_x.element_size() for p in progs)
    held += sum(leaf.numel() * leaf.element_size() for p in progs for leaf in tree_leaves(p.static_out))
    held += 4096 * 16 * 8  # the float64 components on the card
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rt.retire("pca", version)
    rt.close()
    del progs
    gc.collect()
    torch.cuda.synchronize()
    assert before - torch.cuda.memory_allocated() >= held
    assert serving.program_cache_stats()["size"] == 0


def test_concurrent_replay_of_one_entry(cuda):
    """Two threads replay one graph at once: the entry's lock spans copy-in,
    replay and copy-out, so each gets its own rows' answer."""
    model = _models()["pca"]
    gen = torch.Generator(device=cuda).manual_seed(4)
    xs = [torch.randn((6, D), generator=gen, device=cuda, dtype=torch.float64) for _ in range(2)]
    wants = [model.transform(x) for x in xs]
    errors = []

    def worker(i):
        for _ in range(200):
            if not torch.equal(model.transform(xs[i]), wants[i]):
                errors.append(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert serving.program_cache_stats()["compiles"] == 1


def test_capture_bound_bypasses_large_device_batches(cuda, monkeypatch):
    monkeypatch.setenv("TPUML_SERVE_STREAM_BLOCK", "256")
    model = _models()["pca"]
    x = torch.randn((300, D), device=cuda, dtype=torch.float64)
    before = counter_value("serving.cache.bypass")
    out = model.transform(x)
    assert counter_value("serving.cache.bypass") == before + 1
    assert serving.program_cache_stats()["compiles"] == 0
    pc = torch.tensor(model.pc, device=cuda)
    assert torch.equal(out, x @ pc)


def test_pinned_stream_matches_the_kernel_on_each_block(cuda):
    """Host float32 blocks through the pinned double-buffered stream: each
    result is the same kernel on the block widened to float64 on the card,
    bit for bit, and every byte is counted."""
    model = _models()["pca"]
    rng = np.random.default_rng(5)
    blocks = [rng.normal(size=(n, D)).astype(np.float32) for n in (300, 64, 1, 300, 77)]
    h0, d0 = counter_value("serving.h2d.bytes"), counter_value("serving.d2h.bytes")
    outs = list(model.transform(iter(blocks)))
    assert counter_value("serving.h2d.bytes") - h0 == sum(b.nbytes for b in blocks)
    assert counter_value("serving.d2h.bytes") - d0 == sum(o.nbytes for o in outs)
    sig = model.serving_signature()
    for blk, out in zip(blocks, outs):
        x64 = torch.from_numpy(blk).to(cuda).double()
        (want,) = _eager_at_bucket(sig, x64, sig.weights_on(cuda))
        np.testing.assert_array_equal(out, want.cpu().numpy())


def test_runtime_answers_equal_predict_on_the_card(cuda):
    model = _models()["km"]
    rows = np.random.default_rng(6).normal(size=(40, D))
    with ServingRuntime(max_batch=8, max_delay_ms=2.0) as rt:
        rt.register("km", model, warm_buckets=(1, 8))
        futs = [rt.submit("km", r) for r in rows]
        got = np.concatenate([f.result(timeout=60) for f in futs])
    assert counter_value("serving.degraded_batches") == 0
    # Each answer came through bucket 8, as a predict of one row does.
    want = np.concatenate([model.predict(r[None, :]) for r in rows])
    np.testing.assert_array_equal(got, want)
