"""The port's core modules against the JAX package's: data containers,
params, counters and the persistence format. Exact equality throughout:
these modules move and encode values, they do no arithmetic that could
round differently.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import spark_rapids_ml_tpu.core.data as jdata
import spark_rapids_ml_tpu.core.persistence as jpers
from spark_rapids_ml_tpu_torch.core import data as tdata
from spark_rapids_ml_tpu_torch.core import persistence as tpers
from spark_rapids_ml_tpu_torch.core.params import Param, Params, gt, toBoolean, toInt
from spark_rapids_ml_tpu_torch.utils.testing import seeded_matrix
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter, counter_value


def _containers(x: np.ndarray, data) -> dict:
    v = data.Vectors
    return {
        "ndarray": x,
        "partitions": [x[:4], x[4:]],
        "rows": list(x),
        "vectors": [v.dense(r) if i % 2 else v.sparse(len(r), np.flatnonzero(r), r[r != 0])
                    for i, r in enumerate(x)],
        "scipy": sp.csr_matrix(x),
    }


@pytest.mark.parametrize("kind", ["ndarray", "partitions", "rows", "vectors", "scipy"])
def test_partitions_and_features_match_jax(kind):
    x = seeded_matrix(9, 4, 1)
    x[x < 0] = 0.0  # some zeros, so the sparse forms are sparse
    ours, theirs = _containers(x, tdata)[kind], _containers(x, jdata)[kind]
    got, want = tdata.as_partitions(ours), jdata.as_partitions(theirs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and np.array_equal(g, w)
    assert np.array_equal(tdata.as_matrix(ours), jdata.as_matrix(theirs))
    assert tdata.num_features(ours) == jdata.num_features(theirs) == 4
    assert tdata.infer_input_dtype(ours) == jdata.infer_input_dtype(theirs)
    assert not tdata.is_device_array(ours)


def test_tensors_are_device_arrays():
    t = torch.zeros((3, 2), dtype=torch.float32)
    assert tdata.is_device_array(t)
    assert tdata.infer_input_dtype(t) == np.float32
    assert tdata.num_features(t) == 2
    assert tdata.extract_column(t, None) is t


def test_dataframe_and_columns():
    df = tdata.DataFrame({"f": [[1.0, 2.0], [3.0, 4.0]], "y": [0, 1]})
    assert df.columns == ["f", "y"] and df.count() == 2
    assert df.collect() == [([1.0, 2.0], 0), ([3.0, 4.0], 1)]
    assert tdata.extract_column(df, "f") == [[1.0, 2.0], [3.0, 4.0]]
    with pytest.raises(ValueError, match="inputCol"):
        tdata.extract_column(df, None)
    with pytest.raises(KeyError):
        df.select("nope")
    assert tdata.DataFrame.from_rows([(1, 2)], ["a", "b"]).select("b") == [2]
    with pytest.raises(ValueError, match="inconsistent"):
        tdata.as_partitions([np.zeros((2, 3)), np.zeros((2, 4))])
    assert [p.shape for p in tdata.as_partitions(np.zeros((10, 2)), num_partitions=3)] == [
        p.shape for p in jdata.as_partitions(np.zeros((10, 2)), num_partitions=3)]


def test_sparse_vector_encodes_like_the_reference():
    ours = tdata.Vectors.sparse(5, [1, 3], [1.0, 7.0])
    theirs = jdata.Vectors.sparse(5, [1, 3], [1.0, 7.0])
    assert np.array_equal(ours.toArray(), theirs.toArray()) and len(ours) == 5
    assert repr(ours) == repr(theirs)
    with pytest.raises(ValueError):
        tdata.Vectors.sparse(5, [1, 2], [1.0])


class _Toy(Params):
    k = Param("_", "k", "count", lambda v: gt(0)(toInt(v)))
    flag = Param("_", "flag", "a flag", toBoolean)

    def __init__(self, uid=None):
        super().__init__(uid)
        self._setDefault(flag=True)


def test_params_contract():
    a = _Toy().set("k", 3)
    assert a.getOrDefault("k") == 3 and a.isSet("k") and not a.isSet("flag")
    assert a.k.parent == a.uid and a.uid.startswith("_Toy_")
    b = a.copy({a.flag: False})
    assert b.getOrDefault("k") == 3 and b.getOrDefault("flag") is False and b.uid != a.uid
    assert "count" in a.explainParams()
    with pytest.raises(TypeError):
        a.set("flag", 1)
    with pytest.raises(ValueError):
        a.set("k", 0)
    with pytest.raises(KeyError):
        a.getParam("missing")
    assert toInt(np.int64(4)) == 4 and toInt(2.0) == 2
    a.clear("k")
    with pytest.raises(KeyError, match="no default"):
        a.getOrDefault("k")


def test_counters_and_ranges():
    before = counter_value("test.torch.core")
    bump_counter("test.torch.core")
    bump_counter("test.torch.core", 2)
    assert counter_value("test.torch.core") == before + 3
    with TraceRange("a range", TraceColor.GREEN) as r:
        assert r.name == "a range"
    assert TraceColor.GREEN.value == 0xFF76B900


def test_udt_structs_match_the_reference_encoding():
    m = seeded_matrix(3, 2, 2)
    v = seeded_matrix(1, 4, 3)[0]
    assert tpers._matrix_struct(m) == jpers._matrix_struct(m)
    assert tpers._vector_struct(v) == jpers._vector_struct(v)
    assert np.array_equal(tpers.matrix_from_struct(jpers._matrix_struct(m)), m)
    assert np.array_equal(tpers.vector_from_struct(jpers._vector_struct(v)), v)
    sparse = {"type": 0, "size": 4, "indices": [2], "values": [5.0]}
    assert np.array_equal(tpers.vector_from_struct(sparse), [0.0, 0.0, 5.0, 0.0])
