"""The port's environment knobs against the JAX package's.

``utils/envknobs.py`` (the registry and its accessors), the knob readers
built on it (``core/data.fit_block_rows``, ``core/membudget``'s budget,
retries and degrade switch, ``ops/precision.resolve_policy``, the
logistic ``fused`` default, the UMAP tail route), each held against its
JAX twin on the same environment: equal values for valid settings, and
for malformed ones the same exception type with the same message. With
the autotuner off the two packages agree; ``TPUML_AUTOTUNE=on`` raises
``NotImplementedError`` in the port wherever the reference would consult
its tuner. The fits a knob changes are held to the JAX package at the
tolerances of their own test files: logistic weights 1e-7 with equal
``numIter`` (``test_torch_logistic.py``), a pinned-layout UMAP fit 1e-4
(``test_torch_umap.py``).
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLR
from spark_rapids_ml_tpu.core import data as jdata
from spark_rapids_ml_tpu.core import membudget as jmb
from spark_rapids_ml_tpu.manifold import UMAP as JaxUMAP
from spark_rapids_ml_tpu.models import logistic_regression as jlogistic
from spark_rapids_ml_tpu.ops import precision as jprec
from spark_rapids_ml_tpu.utils import envknobs as jknobs
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.classification import LogisticRegression
from spark_rapids_ml_tpu_torch.core import data as tdata
from spark_rapids_ml_tpu_torch.core import membudget as tmb
from spark_rapids_ml_tpu_torch.manifold import UMAP
from spark_rapids_ml_tpu_torch.ops import precision as tprec
from spark_rapids_ml_tpu_torch.ops import umap as pou
from spark_rapids_ml_tpu_torch.utils import envknobs as tknobs

FAMILIES = ("covariance", "pca", "kmeans", "logistic", "linear", "serving")


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


@pytest.fixture(autouse=True)
def clean_knobs(monkeypatch):
    for name in tknobs.KNOBS:
        monkeypatch.delenv(name, raising=False)
    for family in FAMILIES:
        monkeypatch.delenv(tprec.family_env(family), raising=False)


def _outcome(fn):
    try:
        return ("value", fn())
    except Exception as exc:  # the outcome is compared, whatever it is
        return (type(exc).__name__, str(exc))


# Each knob the port reads, through the port's reader and the reference's.
READERS = {
    "TPUML_FIT_MEM_BUDGET": (tmb.fit_mem_budget, jmb.fit_mem_budget),
    "TPUML_FIT_BLOCK_ROWS": (lambda: tdata.fit_block_rows("pca", width=8, itemsize=8),
                             lambda: jdata.fit_block_rows("pca", width=8, itemsize=8)),
    "TPUML_FIT_OOM_RETRIES": (tmb.fit_oom_retries, jmb.fit_oom_retries),
    "TPUML_FIT_DEGRADE": (tmb.degrade_to_streaming_enabled, jmb.degrade_to_streaming_enabled),
    "TPUML_PRECISION": (lambda: tprec.resolve_policy("linear"), lambda: jprec.resolve_policy("linear")),
    "TPUML_PRECISION_KMEANS": (lambda: tprec.resolve_policy("kmeans"), lambda: jprec.resolve_policy("kmeans")),
    "TPUML_LOGISTIC_FUSED": (lambda: LogisticRegression()._use_fused(), jlogistic._logistic_fused_knob),
    "TPUML_UMAP_SCATTER": (
        lambda: tknobs.env_choice("TPUML_UMAP_SCATTER", ("auto", "pallas", "xla"), "auto"),
        lambda: jknobs.env_choice("TPUML_UMAP_SCATTER", ("auto", "pallas", "xla"), "auto")),
    "TPUML_EVENT_LOG": (lambda: tknobs.env_str("TPUML_EVENT_LOG"), lambda: jknobs.env_str("TPUML_EVENT_LOG")),
}

CASES = [
    ("TPUML_FIT_MEM_BUDGET", ["0", "1024", " 4096 ", "-1", "1.5", "lots"]),
    ("TPUML_FIT_BLOCK_ROWS", ["1", "7", "65536", "0", "abc"]),
    ("TPUML_FIT_OOM_RETRIES", ["1", "5", "0", "x"]),
    ("TPUML_FIT_DEGRADE", ["auto", "off", "OFF", " auto ", "on"]),
    ("TPUML_PRECISION", ["f32", "bf16x3", "bf16", "highest", "high", "default", "tf32"]),
    ("TPUML_PRECISION_KMEANS", ["bf16", "high", "dd", ""]),
    ("TPUML_LOGISTIC_FUSED", ["0", "1", "yes"]),
    ("TPUML_UMAP_SCATTER", ["auto", "pallas", "XLA", "cuda"]),
    ("TPUML_EVENT_LOG", ["stderr", "", " /tmp/ev.jsonl "]),
]


@pytest.mark.parametrize("name,value", [(n, v) for n, vals in CASES for v in vals] + [(n, None) for n in READERS])
def test_knob_reads_like_the_reference(monkeypatch, name, value):
    if value is not None:
        monkeypatch.setenv(name, value)
    ours, theirs = READERS[name]
    assert _outcome(ours) == _outcome(theirs)


@pytest.mark.parametrize("name", sorted(tknobs.KNOBS))
def test_every_port_knob_is_registered_in_the_reference(name):
    ours, theirs = tknobs.KNOBS[name], jknobs.KNOBS[name]
    assert (ours.kind, ours.default, ours.choices) == (theirs.kind, theirs.default, theirs.choices)


@pytest.mark.parametrize("accessor", ["env_int", "env_float", "env_str"])
def test_unregistered_knobs_are_refused(monkeypatch, accessor):
    for mod in (tknobs, jknobs):
        with pytest.raises(ValueError, match="not registered"):
            getattr(mod, accessor)("TPUML_" + "NO_SUCH_KNOB")
    monkeypatch.setenv("TPUML_TEST_ANYTHING", "3")
    assert tknobs.env_str("TPUML_TEST_ANYTHING") == jknobs.env_str("TPUML_TEST_ANYTHING") == "3"


def test_env_float_matches_the_reference(monkeypatch):
    # The port registers no float knob; the accessor is exercised through a
    # harness name, which both registries exempt.
    for value in ("0.5", " 2 ", "-1", "half"):
        monkeypatch.setenv("TPUML_TEST_FLOAT", value)
        assert _outcome(lambda: tknobs.env_float("TPUML_TEST_FLOAT", minimum=0.0)) == _outcome(
            lambda: jknobs.env_float("TPUML_TEST_FLOAT", minimum=0.0))


def test_env_knob_error_carries_its_fields(monkeypatch):
    monkeypatch.setenv("TPUML_FIT_OOM_RETRIES", "two")
    with pytest.raises(tknobs.EnvKnobError) as err:
        tmb.fit_oom_retries()
    assert (err.value.name, err.value.value, err.value.expected) == (
        "TPUML_FIT_OOM_RETRIES", "two", "an integer (e.g. 100)")
    assert isinstance(err.value, ValueError)


def test_fit_block_rows_takes_the_reference_signature(monkeypatch):
    assert tdata.fit_block_rows() == tdata.fit_block_rows("kmeans", width=3, itemsize=8) == 65536
    monkeypatch.setenv("TPUML_FIT_BLOCK_ROWS", "4")
    x = np.zeros((10, 3), dtype=np.float32)
    assert tdata.HostArrayBlockReader(x).block_rows == jdata.HostArrayBlockReader(x).block_rows == 4
    monkeypatch.setenv("TPUML_FIT_BLOCK_ROWS", "-4")
    with pytest.raises(tknobs.EnvKnobError, match="an integer >= 1"):
        tdata.fit_block_rows()


# --- resolve_policy -----------------------------------------------------------


LAYERS = {
    "explicit": (dict(requested="bf16"), {"TPUML_PRECISION_{F}": "f32", "TPUML_PRECISION": "bf16x3"}),
    "family_env": (dict(), {"TPUML_PRECISION_{F}": "bf16", "TPUML_PRECISION": "bf16x3"}),
    "global_env": (dict(), {"TPUML_PRECISION": "bf16x3"}),
    "default": (dict(default="high"), {}),
    "auto_request": (dict(requested="auto"), {"TPUML_PRECISION": "bf16"}),
    "auto_no_env": (dict(requested="auto"), {}),
    "dd_request": (dict(requested="dd"), {"TPUML_PRECISION": "bf16"}),
}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("layer", list(LAYERS))
def test_resolve_policy_layers_like_the_reference(monkeypatch, family, layer):
    kwargs, env = LAYERS[layer]
    for name, value in env.items():
        monkeypatch.setenv(name.replace("{F}", family.upper()), value)
    ours = tprec.resolve_policy(family, **kwargs)
    assert ours == jprec.resolve_policy(family, **kwargs)


def test_resolve_policy_refusals_match_the_reference(monkeypatch):
    for fn in (tprec.resolve_policy, jprec.resolve_policy):
        with pytest.raises(ValueError, match="unknown precision family"):
            fn("umap")
        with pytest.raises(ValueError, match="precision mode must be one of"):
            fn("pca", "tf32")
    monkeypatch.setenv("TPUML_PRECISION_PCA", "fp8")
    assert _outcome(lambda: tprec.resolve_policy("pca")) == _outcome(lambda: jprec.resolve_policy("pca"))


def _guard_with_budget(monkeypatch):
    monkeypatch.setenv("TPUML_FIT_MEM_BUDGET", "1000000")
    return tmb.fit_memory_guard("pca", np.zeros((4, 3)), can_stream=True)


AUTOTUNE_SITES = {
    "resolve_policy": lambda mp: tprec.resolve_policy("pca"),
    "fit_block_rows": lambda mp: tdata.fit_block_rows("pca"),
    "fit_memory_guard": _guard_with_budget,
    "run_streaming_with_recovery": lambda mp: tmb.run_streaming_with_recovery(
        "pca", lambda r: None, np.zeros((4, 3))),
}


@pytest.mark.parametrize("site", list(AUTOTUNE_SITES))
def test_autotune_on_is_not_ported(monkeypatch, site):
    monkeypatch.setenv("TPUML_AUTOTUNE", "on")
    with pytest.raises(NotImplementedError, match="A.9"):
        AUTOTUNE_SITES[site](monkeypatch)
    monkeypatch.setenv("TPUML_AUTOTUNE", "off")
    AUTOTUNE_SITES[site](monkeypatch)  # the static branch


def test_explicit_settings_do_not_reach_the_tuner(monkeypatch):
    monkeypatch.setenv("TPUML_AUTOTUNE", "on")
    assert tprec.resolve_policy("pca", "bf16") == "bf16"
    monkeypatch.setenv("TPUML_PRECISION_PCA", "bf16x3")
    assert tprec.resolve_policy("pca") == "bf16x3"
    monkeypatch.setenv("TPUML_FIT_BLOCK_ROWS", "9")
    assert tdata.fit_block_rows("pca") == 9
    assert tdata.HostArrayBlockReader(np.zeros((3, 2)), block_rows=2).block_rows == 2
    monkeypatch.setenv("TPUML_AUTOTUNE", "sometimes")
    monkeypatch.delenv("TPUML_FIT_BLOCK_ROWS")
    with pytest.raises(tknobs.EnvKnobError, match="TPUML_AUTOTUNE"):
        tdata.fit_block_rows()


# --- the fits a knob changes --------------------------------------------------


def _logistic_data():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((200, 4)) * rng.uniform(0.5, 2.0, 4) + rng.uniform(-1, 1, 4)
    y = ((x - x.mean(0)) / x.std(0) @ rng.standard_normal(4) + 0.5 * rng.standard_normal(200) > 0)
    return x, y.astype(np.float64)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_logistic_fused_knob_fits_like_the_reference(monkeypatch, fused):
    monkeypatch.setenv("TPUML_LOGISTIC_FUSED", fused)
    x, y = _logistic_data()
    model = LogisticRegression().setRegParam(0.01).setTol(1e-10).fit((x, y))
    want = JaxLR().setRegParam(0.01).setTol(1e-10).fit((x, y))
    assert model.numIter == want.numIter
    scale = np.abs(want.weights).max()
    np.testing.assert_allclose(model.weights, want.weights, rtol=0, atol=1e-7 * scale)
    np.testing.assert_allclose(model.intercepts, want.intercepts, rtol=0, atol=1e-7 * scale)


def test_the_fused_argument_outranks_the_knob(monkeypatch):
    monkeypatch.setenv("TPUML_LOGISTIC_FUSED", "0")
    assert LogisticRegression(fused=True)._use_fused() is True
    assert LogisticRegression()._use_fused() is False
    monkeypatch.setenv("TPUML_LOGISTIC_FUSED", "1")
    assert LogisticRegression(fused=False)._use_fused() is False
    assert LogisticRegression().copy()._use_fused() is True


def _blobs(rng, n_per=40, d=10, sep=12.0):
    centers = np.zeros((3, d))
    centers[0, 0] = centers[1, 1] = centers[2, 2] = sep
    return np.concatenate([rng.normal(size=(n_per, d)) + c for c in centers])


@pytest.mark.parametrize("route,calls", [("pallas", 3), ("xla", 0), ("auto", 0)])
def test_umap_scatter_knob_takes_its_route(monkeypatch, route, calls):
    """``pallas`` runs K4's wrapper every epoch (its plain version on the
    CPU), ``xla`` and ``auto`` off the card take ``index_add_``; the
    pinned-layout fit stays within 1e-4 of the JAX package's."""
    monkeypatch.setenv("TPUML_UMAP_SCATTER", route)
    seen = []
    real = pou.tail_accumulate
    monkeypatch.setattr(pou, "tail_accumulate", lambda g, plan: seen.append(1) or real(g, plan))
    rng = np.random.default_rng(4)
    x = _blobs(rng)
    y0 = rng.uniform(-10, 10, size=(120, 2)).astype(np.float32)

    def est(cls):
        return (cls().setNNeighbors(8).setNEpochs(3).setRepulsionStrength(0.0)
                .setSeed(2).setInitEmbedding(y0))

    got = est(UMAP).fit(x)
    assert len(seen) == calls
    want = est(JaxUMAP).fit(x)
    np.testing.assert_allclose(got.embedding, want.embedding, atol=1e-4)


def test_precision_knob_reaches_the_fit(monkeypatch):
    """A float32 tensor fit under ``TPUML_PRECISION_PCA=bf16x3`` is the
    ``setPrecision("bf16x3")`` fit, bit for bit."""
    from spark_rapids_ml_tpu_torch.feature import PCA

    x = torch.from_numpy(np.random.default_rng(5).standard_normal((300, 8)).astype(np.float32))
    explicit = PCA().setK(3).setPrecision("bf16x3").fit(x)
    monkeypatch.setenv("TPUML_PRECISION_PCA", "bf16x3")
    by_knob = PCA().setK(3).fit(x)
    np.testing.assert_array_equal(by_knob.pc, explicit.pc)
    np.testing.assert_array_equal(by_knob.explainedVariance, explicit.explainedVariance)
