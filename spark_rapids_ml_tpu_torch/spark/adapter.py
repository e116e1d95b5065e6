"""pyspark.ml-compatible estimator adapter (requires pyspark at import) —
port of the reference's ``spark/adapter.py``, with the same module
layout and names, so the reference's contract suite runs against it.

The reference system's distribution strategy with the port's ops: the
input DataFrame's vector column is lowered to an RDD, partitions stream
through a picklable sufficient-statistics accumulator on executors
(``mapPartitions``), partials merge through ``treeReduce``, and the
driver finishes on its card.

For the training families (PCA, KMeans, LinearRegression, both
RandomForest families) the fit is DISTRIBUTED and executors need numpy
only: the per-partition work is moment or histogram accumulation in row
batches (the numbers that travel are d×d moments or per-level split
histograms, never rows), and transform UDFs close over plain numpy
parameters and ``spark/executor_math.py``. The driver finishes: the
eigendecomposition on the card that ``gpuId`` or the task resource
``"gpu"`` names when ``useCuSolverSVD=True`` (cuSOLVER through
``torch.linalg.eigh``), or numpy when False; the fp64 normal-equation
solve; split selection for the forests (``ops.trees.split_level``, the
core solver's own). LogisticRegression fits through ``spark.barrier.
gang_fit``: each barrier member runs the core fit with
``deployMode='gang'``. The NEIGHBOR families (kNN, ANN, DBSCAN, UMAP)
collect the item set to the driver's card and fit the port's estimators
there (UMAP's layout launches the ``umap_tail`` kernel once an epoch);
their kneighbors UDFs ship the fitted index to executors.

Every driver-side fit computes on the card unless the caller asked for
the CPU (``device.set_platform("cpu")``); there is no quiet fallback.
``useGemm`` is accepted for parity and recorded in params; both
covariance routes share the one streaming accumulator here.
"""

from __future__ import annotations

import numpy as np

try:
    from pyspark import keyword_only  # noqa: F401
    from pyspark.ml import Estimator as SparkEstimator, Model as SparkModel
    from pyspark.ml.linalg import DenseMatrix, DenseVector
    from pyspark.ml.param.shared import Param, Params, TypeConverters
    from pyspark.sql import functions as F  # noqa: F401

    HAS_PYSPARK = True
except ImportError as _err:  # pragma: no cover - exercised only without pyspark
    HAS_PYSPARK = False
    _import_error = _err

    def __getattr__(name):
        raise ImportError(
            "spark_rapids_ml_tpu_torch.spark.adapter requires pyspark; "
            f"original import error: {_import_error}"
        )


if HAS_PYSPARK:  # pragma: no cover - no pyspark in the CI image

    from spark_rapids_ml_tpu_torch.core.moments import ShiftedMoments
    from spark_rapids_ml_tpu_torch.core.persistence import MLReadable
    from spark_rapids_ml_tpu_torch.spark.resources import resolve_device_index

    class _TpuEstimatorPersistence(MLReadable):
        """Estimator save/load (DefaultParamsWritable parity): metadata
        JSON holds the params; load restores them by name onto a fresh
        instance of the concrete class."""

        def _save_impl(self, path):
            from spark_rapids_ml_tpu_torch.core import persistence as P

            P.save_metadata(self, path, class_name=type(self).__name__)

        @classmethod
        def load(cls, path):
            from spark_rapids_ml_tpu_torch.core import persistence as P

            metadata = P.load_metadata(path, expected_class=cls.__name__)
            est = _set_params_from_metadata(cls(), metadata)
            # DefaultParamsReader restores the uid via _resetUid, which
            # also re-parents the instance params and rebuilds the maps —
            # a bare `.uid = ...` would orphan every param (pyspark
            # Params._shouldOwn rejects them afterwards).
            est._resetUid(metadata["uid"])
            return est

    class _TpuCoreModelPersistence(MLReadable):
        """Model save/load for adapters that WRAP a core model: metadata
        at the root, the core model under <path>/core. Subclasses set
        ``_core_class`` to a zero-arg callable returning the core model
        class (lazy import keeps executors torch-free)."""

        _core_class = None

        def _save_impl(self, path):
            import os as _os

            from spark_rapids_ml_tpu_torch.core import persistence as P

            P.save_metadata(self, path, class_name=type(self).__name__)
            self._core.save(_os.path.join(path, "core"))

        @classmethod
        def load(cls, path):
            import os as _os

            from spark_rapids_ml_tpu_torch.core import persistence as P

            metadata = P.load_metadata(path, expected_class=cls.__name__)
            core = cls._core_class().load(_os.path.join(path, "core"))
            model = _set_params_from_metadata(cls(core), metadata)
            model._resetUid(metadata["uid"])  # see _TpuEstimatorPersistence.load
            return model

    def _set_params_from_metadata(obj, metadata):
        """Restore pyspark Param values by name from core metadata JSON —
        defaults go back into the DEFAULT map (DefaultParamsReader
        semantics: a load-save round trip must not migrate defaults into
        paramMap or flip isSet())."""
        for name, value in metadata.get("defaultParamMap", {}).items():
            if obj.hasParam(name):
                param = obj.getParam(name)
                obj._defaultParamMap[param] = param.typeConverter(value)
        for name, value in metadata.get("paramMap", {}).items():
            if obj.hasParam(name):
                obj._set(**{name: value})
        return obj


    class TpuPCA(SparkEstimator, _TpuEstimatorPersistence):
        """Drop-in PCA estimator: ``TpuPCA(k=3, inputCol="features")``.

        Public-surface parity with com.nvidia.spark.ml.feature.PCA
        (PCA.scala:27): same params, same fit/transform/persistence flow,
        the driver's eigensolve on the card through cuSOLVER.
        """

        k = Param(Params._dummy(), "k", "number of principal components", TypeConverters.toInt)
        inputCol = Param(Params._dummy(), "inputCol", "input column", TypeConverters.toString)
        outputCol = Param(Params._dummy(), "outputCol", "output column", TypeConverters.toString)
        meanCentering = Param(Params._dummy(), "meanCentering", "center before covariance", TypeConverters.toBoolean)
        useGemm = Param(Params._dummy(), "useGemm", "dense GEMM covariance", TypeConverters.toBoolean)
        useCuSolverSVD = Param(Params._dummy(), "useCuSolverSVD", "accelerated eigensolver", TypeConverters.toBoolean)
        gpuId = Param(Params._dummy(), "gpuId", "accelerator ordinal, -1 auto", TypeConverters.toInt)

        def __init__(self, k=None, inputCol=None, outputCol=None):
            super().__init__()
            self._setDefault(meanCentering=True, useGemm=True, useCuSolverSVD=True, gpuId=-1)
            if k is not None:
                self._set(k=k)
            if inputCol is not None:
                self._set(inputCol=inputCol)
            if outputCol is not None:
                self._set(outputCol=outputCol)

        def setK(self, value):
            return self._set(k=value)

        def setInputCol(self, value):
            return self._set(inputCol=value)

        def setOutputCol(self, value):
            return self._set(outputCol=value)

        def setMeanCentering(self, value):
            return self._set(meanCentering=value)

        def setUseGemm(self, value):
            return self._set(useGemm=value)

        def setUseCuSolverSVD(self, value):
            return self._set(useCuSolverSVD=value)

        def setGpuId(self, value):
            return self._set(gpuId=value)

        def _fit(self, dataset):
            in_col = self.getOrDefault(self.inputCol)
            k = self.getOrDefault(self.k)
            center = self.getOrDefault(self.meanCentering)
            rdd = dataset.select(in_col).rdd.map(lambda r: r[0])
            first = rdd.first()
            d = len(first.toArray())

            def part_op(rows):
                # Batch rows before the rank-b update: one numpy GEMM per
                # batch instead of a Python call + (1,d) outer product per
                # row (the mapPartitions block streaming of
                # RapidsRowMatrix.scala:170-200).
                acc = ShiftedMoments(d)
                for chunk in _row_batches(rows):
                    acc.add_block(_dense_chunk(chunk, col=None))
                return [acc]

            acc = rdd.mapPartitions(part_op).treeReduce(lambda a, b: a.merge(b))
            cov, _mean = acc.finalize(center=center)

            # Driver-side eigendecomposition (the calSVD-on-driver analogue,
            # RapidsRowMatrix.scala:88-95) on the card gpuId/task resources
            # resolve to, or the NumPy path when useCuSolverSVD is off (the
            # breeze-SVD branch, RapidsRowMatrix.scala:110-123). The float64
            # covariance stays float64 on the card.
            if self.getOrDefault(self.useCuSolverSVD):
                import torch

                from spark_rapids_ml_tpu_torch.ops.eigh import eigh_descending

                device = _driver_device(self.getOrDefault(self.gpuId))
                w, v = eigh_descending(torch.from_numpy(cov).to(device))
                w, v = w.cpu().numpy(), v.cpu().numpy()
            else:
                from spark_rapids_ml_tpu_torch.ops.eigh import eigh_descending_host

                w, v = eigh_descending_host(cov)
            w = np.clip(np.asarray(w), 0, None)
            v = np.asarray(v)
            explained = w / w.sum() if w.sum() > 0 else w
            pc = v[:, :k]
            model = TpuPCAModel(
                DenseMatrix(d, k, pc.ravel(order="F").tolist()),
                DenseVector(explained[:k].tolist()),
            )
            model._set(inputCol=in_col)
            if self.isSet(self.outputCol):
                model._set(outputCol=self.getOrDefault(self.outputCol))
            return model

    class TpuPCAModel(SparkModel, MLReadable):
        inputCol = Param(Params._dummy(), "inputCol", "input column", TypeConverters.toString)
        outputCol = Param(Params._dummy(), "outputCol", "output column", TypeConverters.toString)

        def __init__(self, pc=None, explainedVariance=None):
            super().__init__()
            self.pc = pc
            self.explainedVariance = explainedVariance

        def setOutputCol(self, value):
            return self._set(outputCol=value)

        def _transform(self, dataset):
            from pyspark.ml.functions import array_to_vector, vector_to_array
            from pyspark.sql.functions import col, pandas_udf

            in_col = self.getOrDefault(self.inputCol)
            out_col = (
                self.getOrDefault(self.outputCol)
                if self.isSet(self.outputCol)
                else "pca_features"
            )
            pc = np.asarray(self.pc.toArray())

            # Vectorized batch projection (one NumPy GEMM per Arrow batch) —
            # the working version of the reference's disabled GPU batch
            # transform (RapidsPCA.scala:172-185); a per-row scalar UDF would
            # pay a pickle round-trip + Python call per row.
            @pandas_udf("array<double>")
            def project(series):
                import pandas as pd

                block = np.stack([np.asarray(v, dtype=np.float64) for v in series])
                return pd.Series(list(block @ pc))

            return dataset.withColumn(
                out_col, array_to_vector(project(vector_to_array(col(in_col))))
            )

        def _save_impl(self, path):
            # Reference on-disk layout (RapidsPCA.scala:207-255): params JSON
            # under metadata/, single-row parquet of (pc, explainedVariance)
            # under data/ — via the same writers the core models use.
            from spark_rapids_ml_tpu_torch.core import persistence as P

            P.save_metadata(self, path, class_name="TpuPCAModel")
            P.save_data(
                path,
                {
                    "pc": ("matrix", np.asarray(self.pc.toArray())),
                    "explainedVariance": (
                        "vector",
                        np.asarray(self.explainedVariance.toArray()),
                    ),
                },
            )

        @classmethod
        def load(cls, path):
            from spark_rapids_ml_tpu_torch.core import persistence as P

            metadata = P.load_metadata(path, expected_class="TpuPCAModel")
            data = P.load_data(path)
            pc = np.asarray(data["pc"])
            ev = np.asarray(data["explainedVariance"])
            model = cls(
                DenseMatrix(pc.shape[0], pc.shape[1], pc.ravel(order="F").tolist()),
                DenseVector(ev.tolist()),
            )
            # pyspark Param values set by name (pyspark's typeConverter API
            # differs from the core Params', so core get_and_set_params does
            # not apply here).
            return _set_params_from_metadata(model, metadata)

    # ------------------------------------------------------------------
    # Shared adapter plumbing for the non-PCA families
    # ------------------------------------------------------------------

    def _driver_device(gpu_id=-1):
        """Where this process's card work runs: the visible card ``gpu_id``
        or the Spark task resource names (card 0 by default; inside an
        executor's UDF the task's card at the index this process sees it
        at), or the CPU when the caller set the platform to ``"cpu"``. An
        index beyond the visible cards raises; so does the ``"cuda"``
        platform without a card."""
        from spark_rapids_ml_tpu_torch import device as port_device

        return port_device.resolve_device(resolve_device_index(gpu_id))

    def _collect_features(dataset, features_col):
        """Materialize the feature vectors on the driver (partition-
        streamed fetch) — the fit-side collect of the driver-card
        families."""
        xs = [
            np.asarray(row[0].toArray(), dtype=np.float64)
            for row in dataset.select(features_col).rdd.toLocalIterator()
        ]
        if not xs:
            raise ValueError("empty dataset")
        return np.stack(xs)

    def _driver_rows(x):
        """Rows as a float64 tensor on the driver's device (an executor's
        own card inside a UDF): Spark vectors are doubles and the fit
        keeps their dtype, where a host input would take the port's
        float32 default."""
        import torch

        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64)).to(_driver_device())

    def _prediction_udf(fn, returns="double"):
        """Vectorized Arrow-batch prediction column (one numpy or torch
        batch op per Arrow batch — the working version of the reference's disabled
        batched transform, RapidsPCA.scala:172-185). ``returns="integer"``
        emits an int column (Spark's KMeansModel prediction schema)."""
        from pyspark.sql.functions import pandas_udf

        out_np = np.int32 if returns == "integer" else np.float64

        @pandas_udf(returns)
        def predict(series):
            import pandas as pd

            if len(series) == 0:  # empty partition: nothing to score
                return pd.Series([], dtype=out_np)
            block = np.stack([np.asarray(v, dtype=np.float64) for v in series])
            return pd.Series(np.asarray(fn(block), dtype=out_np))

        return predict

    def _row_batches(rows, size=4096):
        """Yield lists of up to ``size`` rows from a partition iterator —
        THE executor batching convention (one numpy op per batch instead
        of per-row Python work); shared by every mapPartitions op here."""
        batch = []
        for r in rows:
            batch.append(r)
            if len(batch) >= size:
                yield batch
                batch = []
        if batch:
            yield batch

    def _dense_chunk(chunk, col=0):
        """One (rows, d) float64 block from a chunk of Rows (or Vectors when
        ``col is None``) — the densify half of the batching convention."""
        if col is None:
            return np.stack([np.asarray(v.toArray(), dtype=np.float64) for v in chunk])
        return np.stack(
            [np.asarray(r[col].toArray(), dtype=np.float64) for r in chunk]
        )

    class _BroadcastCall:
        """Executor-side shim: tasks ship only the Broadcast HANDLE; the
        heavyweight callable (training matrix + fitted values) serializes
        ONCE at broadcast() time — the reference's broadcast of the
        column means (RapidsRowMatrix.scala:162-166), applied to the
        transform closures."""

        def __init__(self, bc):
            self.bc = bc

        def __call__(self, block):
            return self.bc.value(block)

    class _FittedOrTransform:
        """Callable mapping EXACT training rows to their fitted outputs
        (labels / coordinates) and everything else through the core
        model's transform. Hashing happens at the TRAIN dtype on both
        sides — a core model may store f32 rows, and hashing the
        incoming f64 rows directly would never match. Duplicate
        training rows resolve to the first occurrence. A plain class (not
        a closure) so models stay picklable after caching one."""

        def __init__(self, train, fitted_values, transform_fn):
            # +0.0 collapses -0.0 to +0.0 before byte-hashing: equal rows
            # with representation-distinct zeros must hit the same bucket
            # on both the train and query side.
            self.train = np.ascontiguousarray(train) + 0.0
            self.fitted = np.asarray(fitted_values, dtype=np.float64)
            self.transform_fn = transform_fn
            self.lookup = {}
            for i in range(self.train.shape[0]):
                self.lookup.setdefault(self.train[i].tobytes(), i)

        def __call__(self, block):
            block = np.asarray(block, dtype=np.float64)
            q = np.ascontiguousarray(block.astype(self.train.dtype, copy=False)) + 0.0
            hits = np.asarray([self.lookup.get(row.tobytes(), -1) for row in q])
            shape = (
                (block.shape[0],)
                if self.fitted.ndim == 1
                else (block.shape[0], self.fitted.shape[1])
            )
            out = np.empty(shape)
            if np.any(hits >= 0):
                out[hits >= 0] = self.fitted[hits[hits >= 0]]
            new = hits < 0
            if np.any(new):
                out[new] = np.asarray(
                    self.transform_fn(block[new]), dtype=np.float64
                )
            return out

    def _sq_dists(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
        """(n, k) squared distances via ||x||^2 - 2 x c^T + ||c||^2: one
        (n, d) x (d, k) matmul, no (n, k, d) intermediate (the memory
        discipline of ops/kmeans.py, numpy edition for executors)."""
        d2 = (
            (x * x).sum(axis=1)[:, None]
            - 2.0 * (x @ centers.T)
            + (centers * centers).sum(axis=1)[None, :]
        )
        return np.maximum(d2, 0.0)

    class _TpuPredictorParams(Params):
        featuresCol = Param(Params._dummy(), "featuresCol", "features column", TypeConverters.toString)
        labelCol = Param(Params._dummy(), "labelCol", "label column", TypeConverters.toString)
        predictionCol = Param(Params._dummy(), "predictionCol", "prediction column", TypeConverters.toString)

        def setFeaturesCol(self, value):
            return self._set(featuresCol=value)

        def setLabelCol(self, value):
            return self._set(labelCol=value)

        def setPredictionCol(self, value):
            return self._set(predictionCol=value)

    # ------------------------------------------------------------------
    # KMeans — genuinely distributed Lloyd iterations over the RDD
    # ------------------------------------------------------------------

    class TpuKMeans(SparkEstimator, _TpuPredictorParams, _TpuEstimatorPersistence):
        """Distributed k-means: per-iteration partition-local assignment
        stats (numpy on executors) merged via treeReduce, centers updated
        on the driver — the mllib KMeans aggregation structure with this
        framework's driver-side finishing."""

        k = Param(Params._dummy(), "k", "number of clusters", TypeConverters.toInt)
        maxIter = Param(Params._dummy(), "maxIter", "max iterations", TypeConverters.toInt)
        tol = Param(Params._dummy(), "tol", "convergence tolerance", TypeConverters.toFloat)
        seed = Param(Params._dummy(), "seed", "random seed", TypeConverters.toInt)

        def __init__(self, k=2, featuresCol="features", predictionCol="prediction"):
            super().__init__()
            self._setDefault(
                k=2, maxIter=20, tol=1e-4, seed=0,
                featuresCol="features", predictionCol="prediction",
            )
            self._set(k=k, featuresCol=featuresCol, predictionCol=predictionCol)

        def setK(self, value):
            return self._set(k=value)

        def setMaxIter(self, value):
            return self._set(maxIter=value)

        def setTol(self, value):
            return self._set(tol=value)

        def setSeed(self, value):
            return self._set(seed=value)

        def _fit(self, dataset):
            k = self.getOrDefault(self.k)
            rdd = dataset.select(self.getOrDefault(self.featuresCol)).rdd.map(
                lambda r: r[0]
            )
            # Lloyd re-reads the data every iteration: persist once instead
            # of recomputing the select+deserialize lineage maxIter times
            # (Spark's own KMeans caches the normalized data the same way).
            rdd.persist()
            try:
                # takeSample, not take: take() reads the FIRST partitions,
                # and row order often correlates with structure (sorted
                # labels, time order) — seeding from one partition
                # collapses clusters.
                seed_rows = rdd.takeSample(
                    False, max(10 * k, k), self.getOrDefault(self.seed)
                )
                if not seed_rows:
                    raise ValueError("empty dataset")
                sample = np.stack(
                    [np.asarray(v.toArray(), dtype=np.float64) for v in seed_rows]
                )
                if sample.shape[0] < k:
                    raise ValueError(
                        f"k={k} exceeds the number of rows {sample.shape[0]}"
                    )
                d = sample.shape[1]
                # k-means++ seeding on the driver sample (numpy,
                # deterministic); distances via the Gram expansion
                # ||x||^2 - 2 x c^T + ||c||^2 — never a (n, k, d) tensor
                # (the ops/kmeans.py memory discipline).
                rng = np.random.default_rng(self.getOrDefault(self.seed))
                centers = sample[rng.integers(sample.shape[0])][None, :]
                while centers.shape[0] < k:
                    d2 = np.min(_sq_dists(sample, centers), axis=1)
                    probs = d2 / d2.sum() if d2.sum() > 0 else None
                    centers = np.concatenate(
                        [centers, sample[rng.choice(sample.shape[0], p=probs)][None]]
                    )

                for _ in range(self.getOrDefault(self.maxIter)):
                    c = centers  # closure-captured broadcast analogue

                    def part_op(rows, c=c, k=k, d=d):
                        sums = np.zeros((k, d))
                        counts = np.zeros(k)
                        sse = 0.0
                        for chunk in _row_batches(rows):
                            x = _dense_chunk(chunk, col=None)
                            d2 = _sq_dists(x, c)
                            a = np.argmin(d2, axis=1)
                            np.add.at(sums, a, x)
                            np.add.at(counts, a, 1.0)
                            sse += float(d2[np.arange(len(a)), a].sum())
                        return [(sums, counts, sse)]

                    sums, counts, _sse = rdd.mapPartitions(part_op).treeReduce(
                        lambda a, b: (a[0] + b[0], a[1] + b[1], a[2] + b[2])
                    )
                    new_centers = np.where(
                        counts[:, None] > 0,
                        sums / np.maximum(counts, 1.0)[:, None],
                        centers,
                    )
                    shift = float(
                        np.max(np.linalg.norm(new_centers - centers, axis=1))
                    )
                    centers = new_centers
                    if shift < self.getOrDefault(self.tol):
                        break
            finally:
                rdd.unpersist()

            model = TpuKMeansModel(centers)
            model._set(
                featuresCol=self.getOrDefault(self.featuresCol),
                predictionCol=self.getOrDefault(self.predictionCol),
            )
            return model

    class TpuKMeansModel(SparkModel, _TpuPredictorParams, MLReadable):
        def __init__(self, centers=None):
            super().__init__()
            self._setDefault(featuresCol="features", predictionCol="prediction")
            self._centers = None if centers is None else np.asarray(centers, dtype=np.float64)

        def clusterCenters(self):
            return [c for c in self._centers]

        def _transform(self, dataset):
            from pyspark.ml.functions import vector_to_array
            from pyspark.sql.functions import col

            centers = self._centers

            def assign(block):
                return np.argmin(_sq_dists(block, centers), axis=1)

            # Integer prediction column — Spark's KMeansModel emits
            # IntegerType, and drop-in pipelines match on column type.
            return dataset.withColumn(
                self.getOrDefault(self.predictionCol),
                _prediction_udf(assign, returns="integer")(
                    vector_to_array(col(self.getOrDefault(self.featuresCol)))
                ),
            )

        def _save_impl(self, path):
            from spark_rapids_ml_tpu_torch.core import persistence as P

            P.save_metadata(self, path, class_name="TpuKMeansModel")
            P.save_data(path, {"clusterCenters": ("matrix", self._centers)})

        @classmethod
        def load(cls, path):
            from spark_rapids_ml_tpu_torch.core import persistence as P

            metadata = P.load_metadata(path, expected_class="TpuKMeansModel")
            data = P.load_data(path)
            model = cls(np.asarray(data["clusterCenters"]))
            return _set_params_from_metadata(model, metadata)

    # ------------------------------------------------------------------
    # LinearRegression — distributed normal-equation moments + fp64 solve
    # ------------------------------------------------------------------

    class TpuLinearRegression(SparkEstimator, _TpuPredictorParams, _TpuEstimatorPersistence):
        """Distributed least squares: executors accumulate the [X|y]
        shifted second moments (numpy, picklable), treeReduce merges, the
        driver solves the normal equations in fp64
        (ops.linear.solve_normal_host) — one data pass, d x d on the wire."""

        regParam = Param(Params._dummy(), "regParam", "L2 regularization", TypeConverters.toFloat)
        elasticNetParam = Param(Params._dummy(), "elasticNetParam", "L1 mixing (must be 0)", TypeConverters.toFloat)
        fitIntercept = Param(Params._dummy(), "fitIntercept", "fit intercept", TypeConverters.toBoolean)
        standardization = Param(Params._dummy(), "standardization", "standardize penalty", TypeConverters.toBoolean)

        def __init__(self, featuresCol="features", labelCol="label", predictionCol="prediction"):
            super().__init__()
            self._setDefault(
                regParam=0.0, elasticNetParam=0.0, fitIntercept=True,
                standardization=True, featuresCol="features", labelCol="label",
                predictionCol="prediction",
            )
            self._set(
                featuresCol=featuresCol, labelCol=labelCol, predictionCol=predictionCol
            )

        def setRegParam(self, value):
            return self._set(regParam=value)

        def setElasticNetParam(self, value):
            return self._set(elasticNetParam=value)

        def setFitIntercept(self, value):
            return self._set(fitIntercept=value)

        def setStandardization(self, value):
            return self._set(standardization=value)

        def _fit(self, dataset):
            if self.getOrDefault(self.elasticNetParam) != 0.0:
                raise ValueError(
                    "TpuLinearRegression's distributed normal-equation path "
                    "supports only L2 (elasticNetParam must be 0)"
                )
            f_col = self.getOrDefault(self.featuresCol)
            l_col = self.getOrDefault(self.labelCol)
            rdd = dataset.select(f_col, l_col).rdd
            first = rdd.first()
            d = len(first[0].toArray())

            def part_op(rows, d=d):
                acc = ShiftedMoments(d + 1)
                for chunk in _row_batches(rows):
                    acc.add_block(
                        np.stack(
                            [
                                np.concatenate(
                                    [
                                        np.asarray(row[0].toArray(), dtype=np.float64),
                                        [float(row[1])],
                                    ]
                                )
                                for row in chunk
                            ]
                        )
                    )
                return [acc]

            acc = rdd.mapPartitions(part_op).treeReduce(lambda a, b: a.merge(b))
            raw, mean = acc.finalize(center=False)  # raw 2nd moment / (n-1)
            n = float(acc.n_rows)
            raw = raw * (n - 1.0)
            from spark_rapids_ml_tpu_torch.ops.linear import solve_normal_host

            coef, intercept = solve_normal_host(
                raw[:d, :d],
                raw[:d, d],
                mean[:d] * n,
                mean[d] * n,
                n,
                reg_param=self.getOrDefault(self.regParam),
                fit_intercept=self.getOrDefault(self.fitIntercept),
                standardization=self.getOrDefault(self.standardization),
            )
            model = TpuLinearRegressionModel(
                DenseVector(np.asarray(coef).tolist()), float(intercept)
            )
            model._set(
                featuresCol=f_col,
                labelCol=l_col,
                predictionCol=self.getOrDefault(self.predictionCol),
            )
            return model

    class TpuLinearRegressionModel(SparkModel, _TpuPredictorParams, MLReadable):
        def __init__(self, coefficients=None, intercept=0.0):
            super().__init__()
            self._setDefault(
                featuresCol="features", labelCol="label", predictionCol="prediction"
            )
            self.coefficients = coefficients
            self.intercept = float(intercept)

        def _transform(self, dataset):
            from pyspark.ml.functions import vector_to_array
            from pyspark.sql.functions import col

            coef = np.asarray(self.coefficients.toArray())
            b = self.intercept
            return dataset.withColumn(
                self.getOrDefault(self.predictionCol),
                _prediction_udf(lambda block: block @ coef + b)(
                    vector_to_array(col(self.getOrDefault(self.featuresCol)))
                ),
            )

        def _save_impl(self, path):
            from spark_rapids_ml_tpu_torch.core import persistence as P

            P.save_metadata(self, path, class_name="TpuLinearRegressionModel")
            P.save_data(
                path,
                {
                    "coefficients": ("vector", np.asarray(self.coefficients.toArray())),
                    "intercept": ("scalar", self.intercept),
                },
            )

        @classmethod
        def load(cls, path):
            from spark_rapids_ml_tpu_torch.core import persistence as P

            metadata = P.load_metadata(path, expected_class="TpuLinearRegressionModel")
            data = P.load_data(path)
            model = cls(
                DenseVector(np.asarray(data["coefficients"]).tolist()),
                float(data["intercept"]),
            )
            return _set_params_from_metadata(model, metadata)

    # ------------------------------------------------------------------
    # LogisticRegression / RandomForest — distributed fits: executors
    # accumulate gradient/histogram partials, the driver runs the
    # optimizer / split-selection step each iteration
    # ------------------------------------------------------------------

    class _TpuProbabilisticParams(_TpuPredictorParams):
        probabilityCol = Param(Params._dummy(), "probabilityCol", "probability column", TypeConverters.toString)
        rawPredictionCol = Param(Params._dummy(), "rawPredictionCol", "raw prediction column", TypeConverters.toString)

        def setProbabilityCol(self, value):
            return self._set(probabilityCol=value)

        def setRawPredictionCol(self, value):
            return self._set(rawPredictionCol=value)

    def _classifier_transform(forward, n_classes, adapter):
        """Append rawPrediction / probability / prediction columns from a
        numpy-only ``forward(block) -> (raw, probs, pred)`` callable.

        ONE forward pass per Arrow batch: the combined [raw | probs | pred]
        scores land in a temporary array column, and the three public
        columns are cheap slices of it. ``forward`` must close over plain
        numpy arrays + spark.executor_math functions only — executors have
        numpy, not torch (module docstring contract).
        """

        def _apply(dataset):
            from pyspark.ml.functions import array_to_vector, vector_to_array
            from pyspark.sql.functions import col, pandas_udf

            feats = vector_to_array(
                col(adapter.getOrDefault(adapter.featuresCol))
            )

            @pandas_udf("array<double>")
            def scores(series):
                import pandas as pd

                if len(series) == 0:
                    return pd.Series([], dtype=object)
                block = np.stack(
                    [np.asarray(v, dtype=np.float64) for v in series]
                )
                raw, probs, pred = forward(block)
                return pd.Series(
                    list(np.concatenate([raw, probs, pred[:, None]], axis=1))
                )

            def slice_vec(lo, hi):
                @pandas_udf("array<double>")
                def s(series):
                    import pandas as pd

                    return pd.Series([np.asarray(v)[lo:hi] for v in series])

                return s

            @pandas_udf("double")
            def last(series):
                import pandas as pd

                return pd.Series([float(np.asarray(v)[-1]) for v in series])

            tmp = "_tpu_scores"
            out = dataset.withColumn(tmp, scores(feats))
            c = n_classes
            out = out.withColumn(
                adapter.getOrDefault(adapter.rawPredictionCol),
                array_to_vector(slice_vec(0, c)(col(tmp))),
            )
            out = out.withColumn(
                adapter.getOrDefault(adapter.probabilityCol),
                array_to_vector(slice_vec(c, 2 * c)(col(tmp))),
            )
            out = out.withColumn(
                adapter.getOrDefault(adapter.predictionCol), last(col(tmp))
            )
            return out.drop(tmp)

        return _apply

    class TpuLogisticRegression(SparkEstimator, _TpuProbabilisticParams, _TpuEstimatorPersistence):
        maxIter = Param(Params._dummy(), "maxIter", "max iterations", TypeConverters.toInt)
        regParam = Param(Params._dummy(), "regParam", "regularization", TypeConverters.toFloat)
        elasticNetParam = Param(Params._dummy(), "elasticNetParam", "L1/L2 mixing", TypeConverters.toFloat)

        def __init__(self, featuresCol="features", labelCol="label"):
            super().__init__()
            self._setDefault(
                maxIter=100, regParam=0.0, elasticNetParam=0.0,
                featuresCol="features", labelCol="label",
                predictionCol="prediction", probabilityCol="probability",
                rawPredictionCol="rawPrediction",
            )
            self._set(featuresCol=featuresCol, labelCol=labelCol)

        def setMaxIter(self, value):
            return self._set(maxIter=value)

        def setRegParam(self, value):
            return self._set(regParam=value)

        def setElasticNetParam(self, value):
            return self._set(elasticNetParam=value)

        def _fit(self, dataset):
            # ONE distributed path (no full-dataset collect): the gang
            # deploy switch. Partitions coalesce onto
            # the gang roster (TPUML_GANG_FIT_MEMBERS), each barrier
            # member materializes only ITS rows and calls the public
            # core fit with deployMode='gang' — the solver's psum'd
            # reductions produce the identical whole-dataset model on
            # every member, for L2, elastic-net, and multinomial alike.
            # This replaces the driver-orchestrated L-BFGS/FISTA twins
            # that duplicated the core solvers in executor numpy.
            from spark_rapids_ml_tpu_torch.classification import (
                LogisticRegression as CoreLogisticRegression,
            )
            from spark_rapids_ml_tpu_torch.spark.barrier import (
                _gang_extract,
                gang_fit,
            )
            from spark_rapids_ml_tpu_torch.utils.envknobs import env_int

            f_col = self.getOrDefault(self.featuresCol)
            l_col = self.getOrDefault(self.labelCol)
            rdd = dataset.select(f_col, l_col).rdd
            members = env_int("TPUML_GANG_FIT_MEMBERS", 1, minimum=1)
            if rdd.getNumPartitions() != members:
                rdd = rdd.coalesce(members)

            def extract(it):
                # Executor-side label validation (Spark rejects
                # non-integer labels; silent truncation would fold 1.5
                # into class 1) — the partition never leaves the member.
                x, y = _gang_extract(it, labeled=True)
                bad = (y != np.rint(y)) | (y < 0)
                if np.any(bad):
                    raise ValueError(
                        "labels must be non-negative integers, got "
                        f"{y[bad][0]!r}"
                    )
                return x, y

            core = (
                CoreLogisticRegression()
                .setMaxIter(self.getOrDefault(self.maxIter))
                .setRegParam(self.getOrDefault(self.regParam))
                .setElasticNetParam(self.getOrDefault(self.elasticNetParam))
            )
            models = gang_fit(core, rdd, extract=extract)
            return self._wrap(models[0])

        def _wrap(self, core):
            model = TpuLogisticRegressionModel(core)
            for p in ("featuresCol", "labelCol", "predictionCol", "probabilityCol", "rawPredictionCol"):
                model._set(**{p: self.getOrDefault(getattr(self, p))})
            return model

    class TpuLogisticRegressionModel(SparkModel, _TpuProbabilisticParams, _TpuCoreModelPersistence):
        def __init__(self, core_model=None):
            super().__init__()
            self._setDefault(
                featuresCol="features", labelCol="label",
                predictionCol="prediction", probabilityCol="probability",
                rawPredictionCol="rawPrediction",
            )
            self._core = core_model

        @property
        def coefficients(self):
            return DenseVector(self._core.coefficients.tolist())

        @property
        def intercept(self):
            return float(self._core.intercept)

        def _transform(self, dataset):
            import functools

            from spark_rapids_ml_tpu_torch.spark import executor_math

            # Extract plain numpy params on the driver; the closure ships
            # arrays + a numpy-only module function to executors (no torch).
            forward = functools.partial(
                executor_math.logistic_forward,
                np.asarray(self._core.weights, dtype=np.float64),
                np.asarray(self._core.intercepts, dtype=np.float64),
                float(self._core.getThreshold()),
            )
            return _classifier_transform(forward, self._core.numClasses, self)(dataset)

        @staticmethod
        def _core_class():
            from spark_rapids_ml_tpu_torch.models.logistic_regression import LogisticRegressionModel

            return LogisticRegressionModel

    # ------------------------------------------------------------------
    # Distributed random-forest fit: per-level executor
    # histogram partials merged by treeReduce, split decisions on the
    # driver with the SAME math the core solver uses
    # (ops.trees.split_level) — the mapPartitions+treeAggregate structure
    # of the covariance (RapidsRowMatrix.scala:170-233) applied per tree
    # level. No row ever travels to the driver except a bounded quantile
    # sample (the split-finding sample, as in Spark MLlib's findSplits).
    # ------------------------------------------------------------------

    # Rows the driver may fetch for quantile split finding; tests shrink
    # it to prove the no-full-collect property at small n.
    _QUANTILE_SAMPLE_CAP = 65536

    def _fit_forest_rdd(
        rdd, *, n_trees, max_depth, max_bins, seed, impurity, classification,
        subsampling_rate, bootstrap, feature_subset,
    ):
        """Grow a Forest over an RDD of (features, label) rows without
        collecting the dataset: ``max_depth + 2`` passes total (label
        stats, one histogram pass per level, bottom-level totals), each a
        mapPartitionsWithIndex + treeReduce of additive numpy partials.
        Executors re-derive bootstrap weights per level from
        (seed, partition index, in-partition position) instead of
        shipping state — the same deterministic per-partition-seeded
        scheme as Spark MLlib's BaggedPoint (XORShiftRandom(seed +
        partitionIndex)), with the same contract: the input lineage must
        place rows deterministically across recomputes.

        The driver side is the core fit's (``models/random_forest``):
        quantile edges by ``ops.trees.quantize_features`` on the sample,
        rows binned and routed at float32 on the executors as the core
        bins them, each level's split search by ``ops.trees.split_level``
        on the driver's device, and the feature-subset draws from the
        core's generator (seeded by ``seed``, advanced past the core's
        bootstrap draw), so on the same rows with nothing drawn on the
        executors the forest is the core fit's."""
        import torch

        from spark_rapids_ml_tpu_torch.models.random_forest import (
            _forest_draws,
            resolve_feature_subset,
        )
        from spark_rapids_ml_tpu_torch.ops.trees import (
            Forest,
            _impurity,
            _leaf_prediction,
            _level_uniforms,
            quantize_features,
            sample_weights,
            split_level,
        )
        from spark_rapids_ml_tpu_torch.spark import executor_math as EM

        dev = _driver_device()
        rdd.persist()
        try:
            d = len(rdd.first()[0].toArray())

            def label_op(rows):
                n_loc, s, y_max, bad = 0, 0.0, 0.0, False
                for chunk in _row_batches(rows):
                    ys = np.asarray([float(r[1]) for r in chunk])
                    n_loc += ys.size
                    s += float(ys.sum())
                    y_max = max(y_max, float(ys.max()))
                    bad = bad or bool(
                        np.any(ys != np.rint(ys)) or np.any(ys < 0)
                    )
                return [(n_loc, s, y_max, bad)] if n_loc else []

            n, y_sum, y_max, y_bad = rdd.mapPartitions(label_op).treeReduce(
                lambda a, b: (
                    a[0] + b[0], a[1] + b[1], max(a[2], b[2]), a[3] or b[3]
                )
            )
            if classification:
                if y_bad:
                    raise ValueError("labels must be non-negative integers")
                n_classes = max(int(y_max) + 1, 2)
                y_mean = 0.0
                s_dim = n_classes
            else:
                n_classes = 0
                y_mean = y_sum / n
                s_dim = 3

            # Quantile edges from a BOUNDED row sample (Spark MLlib's
            # findSplits samples the same way), by the core's quantile
            # rule at the core's f32.
            n_bins = min(max_bins, max(2, n))
            # One-pass uniform bounded draw: Bernoulli at a modestly
            # inflated fraction (rows cross the wire ~1.2×cap), then a
            # uniform driver-side subsample to the cap — the retained
            # sample is strictly bounded and unbiased, and no extra
            # count() job runs (the treeReduce above produced n).
            if n <= _QUANTILE_SAMPLE_CAP:
                sample_rows = rdd.collect()
            else:
                fraction = min(1.0, 1.2 * _QUANTILE_SAMPLE_CAP / n)
                drawn = rdd.sample(False, fraction, seed).collect()
                if len(drawn) > _QUANTILE_SAMPLE_CAP:
                    pick = np.random.default_rng(seed).choice(
                        len(drawn), size=_QUANTILE_SAMPLE_CAP, replace=False
                    )
                    drawn = [drawn[i] for i in pick]
                sample_rows = drawn
            if not sample_rows:  # pathological draw: fall back
                sample_rows = rdd.take(min(n, _QUANTILE_SAMPLE_CAP))
            sx = np.stack(
                [np.asarray(r[0].toArray(), dtype=np.float64) for r in sample_rows]
            ).astype(np.float32)
            edges_t = quantize_features(torch.from_numpy(sx).to(dev), n_bins)  # (d, B-1)
            edges = edges_t.cpu().numpy()

            m_sub = resolve_feature_subset(
                feature_subset, d, n_trees, classification
            )
            gen = None
            if m_sub < d:
                # The core's generator, past the core's bootstrap draw, so
                # the per-level feature-subset draws are the core's.
                gen = _forest_draws(seed, dev)
                sample_weights(gen, n_trees, n, subsampling_rate, bootstrap)

            if classification:
                def stats_of(y):
                    rs = np.zeros((y.size, n_classes))
                    rs[np.arange(y.size), y.astype(np.int64)] = 1.0
                    return rs
            else:
                def stats_of(y, mu=y_mean):
                    yc = y - mu
                    return np.stack([np.ones_like(yc), yc, yc * yc], axis=1)

            n_total = 2 ** (max_depth + 1) - 1
            T = n_trees
            s_out = s_dim if classification else 1

            def zeros(*shape, dtype=torch.float32):
                return torch.zeros(shape, dtype=dtype, device=dev)

            feature = torch.full((T, n_total), -1, dtype=torch.int32, device=dev)
            threshold = zeros(T, n_total)
            is_leaf = zeros(T, n_total, dtype=torch.bool)
            leaf_value = zeros(T, n_total, s_out)
            node_weight = zeros(T, n_total)
            node_gain = zeros(T, n_total)
            node_imp = zeros(T, n_total)

            def partials_op(level, offset, m_nodes, want_hist,
                            feat_b, thr_b):
                """Executor op: route rows through the broadcast partial
                forest, return ONE additive partial (histogram or node
                totals) for this partition."""

                def op(pi, rows):
                    rng = EM.tree_weight_rng(seed, pi)
                    acc = None
                    for chunk in _row_batches(rows):
                        x = _dense_chunk(chunk).astype(np.float32)
                        y = np.asarray([float(r[1]) for r in chunk])
                        w = EM.draw_tree_weights(
                            rng, T, x.shape[0], subsampling_rate, bootstrap
                        )
                        rs = stats_of(y)
                        idx = EM.forest_route(feat_b, thr_b, x, level)
                        if want_hist:
                            part = EM.level_histogram_partial(
                                idx, w, EM.bin_columns(x, edges), rs,
                                offset, m_nodes, n_bins,
                            )
                        else:
                            part = EM.node_totals_partial(
                                idx, w, rs, offset, m_nodes
                            )
                        acc = part if acc is None else acc + part
                    return [] if acc is None else [acc]

                return op

            def host(t):
                return t.cpu().numpy().copy()

            for level in range(max_depth):
                offset = 2**level - 1
                m_nodes = 2**level
                hist = rdd.mapPartitionsWithIndex(
                    partials_op(level, offset, m_nodes, True,
                                host(feature), host(threshold))
                ).treeReduce(lambda a, b: a + b)
                u = None
                if m_sub < d:
                    u = _level_uniforms(None, gen, level, (T, m_nodes, d), dev)
                f_b, b_b, g_b, ok, total, w_par = split_level(
                    torch.from_numpy(hist).to(device=dev, dtype=torch.float32), u,
                    impurity=impurity, feat_subset=m_sub,
                )
                sl = slice(offset, offset + m_nodes)
                feature[:, sl] = torch.where(ok, f_b, -1)
                threshold[:, sl] = torch.where(ok, edges_t[f_b.long(), b_b.long()], 0.0)
                is_leaf[:, sl] = ~ok
                leaf_value[:, sl, :] = _leaf_prediction(total, impurity)
                node_weight[:, sl] = w_par
                node_gain[:, sl] = torch.where(ok, g_b, 0.0)
                node_imp[:, sl] = _impurity(total, impurity)[0]

            offset = 2**max_depth - 1
            m_nodes = 2**max_depth
            tot = rdd.mapPartitionsWithIndex(
                partials_op(max_depth, offset, m_nodes, False,
                            host(feature), host(threshold))
            ).treeReduce(lambda a, b: a + b)
            tot = torch.from_numpy(tot).to(device=dev, dtype=torch.float32)
            sl = slice(offset, offset + m_nodes)
            is_leaf[:, sl] = True
            leaf_value[:, sl, :] = _leaf_prediction(tot, impurity)
            imp_bottom, w_bottom = _impurity(tot, impurity)
            node_weight[:, sl] = w_bottom
            node_imp[:, sl] = imp_bottom
        finally:
            rdd.unpersist()

        if not classification:
            leaf_value = leaf_value + y_mean  # the core's add-back
        forest = Forest(
            feature, threshold, is_leaf, leaf_value, node_weight, node_gain, node_imp
        )
        return forest, d, n_classes

    class TpuRandomForestClassifier(SparkEstimator, _TpuProbabilisticParams, _TpuEstimatorPersistence):
        numTrees = Param(Params._dummy(), "numTrees", "number of trees", TypeConverters.toInt)
        maxDepth = Param(Params._dummy(), "maxDepth", "max tree depth", TypeConverters.toInt)
        maxBins = Param(Params._dummy(), "maxBins", "max feature bins", TypeConverters.toInt)
        seed = Param(Params._dummy(), "seed", "random seed", TypeConverters.toInt)
        impurity = Param(Params._dummy(), "impurity", "gini or entropy", TypeConverters.toString)
        subsamplingRate = Param(Params._dummy(), "subsamplingRate", "row sampling rate per tree", TypeConverters.toFloat)
        bootstrap = Param(Params._dummy(), "bootstrap", "sample with replacement", TypeConverters.toBoolean)
        featureSubsetStrategy = Param(Params._dummy(), "featureSubsetStrategy", "features considered per split", TypeConverters.toString)

        def __init__(self, featuresCol="features", labelCol="label"):
            super().__init__()
            self._setDefault(
                numTrees=20, maxDepth=5, maxBins=32, seed=0, impurity="gini",
                subsamplingRate=1.0, bootstrap=True,
                featureSubsetStrategy="auto",
                featuresCol="features", labelCol="label",
                predictionCol="prediction", probabilityCol="probability",
                rawPredictionCol="rawPrediction",
            )
            self._set(featuresCol=featuresCol, labelCol=labelCol)

        def setNumTrees(self, value):
            return self._set(numTrees=value)

        def setMaxDepth(self, value):
            return self._set(maxDepth=value)

        def setMaxBins(self, value):
            return self._set(maxBins=value)

        def setSeed(self, value):
            return self._set(seed=value)

        def setImpurity(self, value):
            return self._set(impurity=value)

        def setSubsamplingRate(self, value):
            return self._set(subsamplingRate=value)

        def setBootstrap(self, value):
            return self._set(bootstrap=value)

        def setFeatureSubsetStrategy(self, value):
            return self._set(featureSubsetStrategy=value)

        def _fit(self, dataset):
            from spark_rapids_ml_tpu_torch.models.random_forest import (
                RandomForestClassificationModel,
            )

            rdd = dataset.select(
                self.getOrDefault(self.featuresCol),
                self.getOrDefault(self.labelCol),
            ).rdd
            forest, d, n_classes = _fit_forest_rdd(
                rdd,
                n_trees=self.getOrDefault(self.numTrees),
                max_depth=self.getOrDefault(self.maxDepth),
                max_bins=self.getOrDefault(self.maxBins),
                seed=self.getOrDefault(self.seed),
                impurity=self.getOrDefault(self.impurity),
                classification=True,
                subsampling_rate=self.getOrDefault(self.subsamplingRate),
                bootstrap=self.getOrDefault(self.bootstrap),
                feature_subset=self.getOrDefault(self.featureSubsetStrategy),
            )
            core = RandomForestClassificationModel(
                None, forest, numFeatures=d, numClasses=n_classes
            )
            model = TpuRandomForestClassificationModel(core)
            for p in ("featuresCol", "labelCol", "predictionCol", "probabilityCol", "rawPredictionCol"):
                model._set(**{p: self.getOrDefault(getattr(self, p))})
            return model

    class TpuRandomForestClassificationModel(SparkModel, _TpuProbabilisticParams, _TpuCoreModelPersistence):
        def __init__(self, core_model=None):
            super().__init__()
            self._setDefault(
                featuresCol="features", labelCol="label",
                predictionCol="prediction", probabilityCol="probability",
                rawPredictionCol="rawPrediction",
            )
            self._core = core_model

        @property
        def numClasses(self):
            return self._core.numClasses

        def _transform(self, dataset):
            import functools

            from spark_rapids_ml_tpu_torch.core.lazy_state import to_host
            from spark_rapids_ml_tpu_torch.models.random_forest import _forest_depth
            from spark_rapids_ml_tpu_torch.spark import executor_math

            f = self._core._forest
            forward = functools.partial(
                executor_math.forest_forward,
                to_host(f.feature),
                to_host(f.threshold, np.float64),
                to_host(f.is_leaf),
                to_host(f.leaf_value, np.float64),
                _forest_depth(f),
            )
            return _classifier_transform(forward, self._core.numClasses, self)(dataset)

        @staticmethod
        def _core_class():
            from spark_rapids_ml_tpu_torch.models.random_forest import RandomForestClassificationModel

            return RandomForestClassificationModel

    class _TpuNeighborsBase(SparkEstimator, _TpuPredictorParams, _TpuEstimatorPersistence):
        """Shared surface of the neighbor estimators: fit collects the item
        vectors to the driver's card (the modern spark-rapids-ml deployment
        shape for its no-Spark-ML-equivalent families), and the model's
        ``kneighbors`` appends distances/indices array columns to a query
        DataFrame via one Arrow-batch search per partition.

        UNLIKE the classic families (numpy-only executors), the kneighbors
        UDF ships the accelerated index/model to executors — searches run
        the port's torch ops there, exactly as the modern reference
        requires cuML on its executors for these families."""

        k = Param(Params._dummy(), "k", "neighbors per query", TypeConverters.toInt)
        inputCol = Param(Params._dummy(), "inputCol", "item/query vector column", TypeConverters.toString)
        indexMode = Param(
            Params._dummy(), "indexMode",
            "collected (driver-card index) | sharded (executor-local "
            "partition shards, treeReduce top-k merge)",
            TypeConverters.toString,
        )

        def setK(self, value):
            return self._set(k=value)

        def setInputCol(self, value):
            return self._set(inputCol=value)

        def setIndexMode(self, value):
            """``"sharded"`` keeps each partition's items ON ITS EXECUTOR
            as a local index shard: queries broadcast,
            shard-local numpy top-k (executor_math.knn_shard_topk), one
            treeReduce candidate merge — the partition-local
            compute+merge shape of the reference's covariance path
            (RapidsRowMatrix.scala:170-201), so ANN/kNN capacity scales
            with the CLUSTER, not one card's memory. ``"collected"``
            (default) keeps the driver-card accelerated index."""
            if value not in ("collected", "sharded"):
                raise ValueError(
                    f"indexMode must be collected|sharded, got {value!r}"
                )
            return self._set(indexMode=value)

        def _collect_items(self, dataset):
            return _collect_features(dataset, self.getOrDefault(self.inputCol))

        def _build_shards(self, dataset):
            """Per-partition (global_offset, items_block) RDD — items never
            leave their executors; only the per-partition COUNTS cross to
            the driver (to fix global row offsets)."""
            col_name = self.getOrDefault(self.inputCol)
            rows = dataset.select(col_name).rdd

            def to_block(_, it):
                xs = [np.asarray(r[0].toArray(), dtype=np.float64) for r in it]
                yield np.stack(xs) if xs else np.zeros((0, 0))

            blocks = rows.mapPartitionsWithIndex(to_block).cache()
            counts = blocks.mapPartitionsWithIndex(
                lambda i, it: [(i, sum(b.shape[0] for b in it))]
            ).collect()
            offsets = {}
            acc = 0
            for i, c in sorted(counts):
                offsets[i] = acc
                acc += c
            if acc == 0:
                raise ValueError("empty dataset")

            def attach_offset(i, it):
                for b in it:
                    if b.shape[0]:
                        yield (offsets[i], b)

            shards = blocks.mapPartitionsWithIndex(attach_offset).cache()
            # Materialize the shard cache, then drop the intermediate
            # blocks cache — keeping both would hold TWO copies of the
            # item set in executor storage for the model's lifetime.
            shards.count()
            blocks.unpersist()
            return shards, acc

    class _TpuNeighborsModelBase(SparkModel, _TpuPredictorParams):
        k = _TpuNeighborsBase.k
        inputCol = _TpuNeighborsBase.inputCol

        def __init__(self, core_model=None, shards=None, metric="euclidean"):
            super().__init__()
            self._setDefault(inputCol="features", k=5)
            self._core = core_model
            self._shards = shards  # (rdd of (offset, block), n_items) or None
            self._shard_metric = metric

        def kneighbors(self, dataset, k=None):
            """Append ``distances`` / ``indices`` array columns (original
            item row indices) to the query DataFrame."""
            from pyspark.ml.functions import vector_to_array
            from pyspark.sql.functions import col, pandas_udf

            core = self._core
            k_eff = int(k if k is not None else self.getOrDefault(self.k))
            if self._shards is not None:
                return self._kneighbors_sharded(dataset, k_eff)

            @pandas_udf("array<double>")
            def knn_pairs(series):
                import pandas as pd

                if len(series) == 0:  # empty query partition
                    return pd.Series([], dtype=object)
                block = np.stack([np.asarray(v, dtype=np.float64) for v in series])
                d, i = core.kneighbors(_driver_rows(block), k=k_eff)
                d, i = d.cpu().numpy(), i.cpu().numpy()
                packed = np.concatenate(
                    [np.asarray(d, dtype=np.float64), np.asarray(i, dtype=np.float64)],
                    axis=1,
                )
                return pd.Series(list(packed))

            def slice_arr(lo, hi):
                @pandas_udf("array<double>")
                def s(series):
                    import pandas as pd

                    return pd.Series([np.asarray(v)[lo:hi] for v in series])

                return s

            @pandas_udf("array<long>")
            def indices_slice(series):
                import pandas as pd

                return pd.Series(
                    [
                        np.asarray(v)[k_eff : 2 * k_eff].astype(np.int64)
                        for v in series
                    ]
                )

            feats = vector_to_array(col(self.getOrDefault(self.inputCol)))
            tmp = "_tpu_knn"
            out = dataset.withColumn(tmp, knn_pairs(feats))
            out = out.withColumn("distances", slice_arr(0, k_eff)(col(tmp)))
            # Indices surface as INTEGERS (the reference's column type),
            # not float-coerced doubles.
            out = out.withColumn("indices", indices_slice(col(tmp)))
            return out.drop(tmp)

        def _kneighbors_sharded(self, dataset, k_eff):
            """Executor-sharded search: the QUERY batch
            crosses to the driver once (queries are the small side of an
            ANN deployment), each item shard computes its local numpy
            top-k where it lives, and one treeReduce merges candidates —
            the item set NEVER crosses executor->driver. Results attach
            by query position via one pandas_udf pass, keyed on a
            per-partition offset map computed the same way the shards
            fixed theirs."""
            import pandas as pd
            from pyspark.ml.functions import vector_to_array
            from pyspark.sql.functions import col, pandas_udf

            from spark_rapids_ml_tpu_torch.spark.executor_math import (
                knn_merge_candidates,
                knn_shard_topk,
            )

            shards_rdd, n_items = self._shards
            if not 1 <= k_eff <= n_items:
                raise ValueError(f"k must be in [1, {n_items}], got {k_eff}")
            col_name = self.getOrDefault(self.inputCol)
            metric = self._shard_metric
            q_rows = [
                np.asarray(row[0].toArray(), dtype=np.float64)
                for row in dataset.select(col_name).rdd.toLocalIterator()
            ]
            if not q_rows:
                # Empty query set (routine after a filter): nothing to
                # search; the attach UDF below handles empty partitions.
                q = np.zeros((0, 1))
                packed = np.zeros((0, 2 * k_eff))
            else:
                q = np.stack(q_rows)

                def shard_topk(it):
                    for offset, block in it:
                        yield knn_shard_topk(q, block, offset, k_eff, metric)

                d, idx = shards_rdd.mapPartitions(shard_topk).treeReduce(
                    lambda a, b: knn_merge_candidates(a, b, k_eff)
                )
                packed = np.concatenate([d, idx.astype(np.float64)], axis=1)

            # Attach by CONTENT, not position: a bytes-keyed map from the
            # exact f64 query vector to its packed result, shipped as ONE
            # broadcast (handle-only task closures — the same contract
            # the transform closures follow). Positional attachment via
            # shared driver state would silently misalign on a real
            # multi-executor cluster; content keys are executor-safe, and
            # duplicate query vectors correctly share one result.
            res_bc = dataset.sparkSession.sparkContext.broadcast(
                {vec.tobytes(): row for vec, row in zip(q, packed)}
            )

            @pandas_udf("array<double>")
            def attach(series):
                if len(series) == 0:
                    return pd.Series([], dtype=object)
                res_map = res_bc.value
                return pd.Series(
                    [
                        res_map[np.asarray(v, dtype=np.float64).tobytes()]
                        for v in series
                    ]
                )

            def slice_arr(lo, hi, cast=None):
                @pandas_udf("array<double>" if cast is None else "array<long>")
                def s(series):
                    return pd.Series(
                        [
                            np.asarray(v)[lo:hi]
                            if cast is None
                            else np.asarray(v)[lo:hi].astype(np.int64)
                            for v in series
                        ]
                    )

                return s

            feats = vector_to_array(col(col_name))
            tmp = "_tpu_knn"
            out = dataset.withColumn(tmp, attach(feats))
            out = out.withColumn("distances", slice_arr(0, k_eff)(col(tmp)))
            out = out.withColumn(
                "indices", slice_arr(k_eff, 2 * k_eff, cast=True)(col(tmp))
            )
            return out.drop(tmp)

    class TpuNearestNeighbors(_TpuNeighborsBase):
        """Exact kNN (the modern spark-rapids-ml NearestNeighbors)."""

        metric = Param(Params._dummy(), "metric", "euclidean|sqeuclidean|cosine", TypeConverters.toString)

        def __init__(self, k=5, inputCol="features"):
            super().__init__()
            self._setDefault(k=5, inputCol="features", metric="euclidean",
                             indexMode="collected",
                             predictionCol="prediction", featuresCol="features",
                             labelCol="label")
            self._set(k=k, inputCol=inputCol)

        def setMetric(self, value):
            return self._set(metric=value)

        def _fit(self, dataset):
            from spark_rapids_ml_tpu_torch.neighbors import NearestNeighbors

            metric = self.getOrDefault(self.metric)
            if self.getOrDefault(self.indexMode) == "sharded":
                shards = self._build_shards(dataset)
                model = TpuNearestNeighborsModel(
                    None, shards=shards, metric=metric
                )
            else:
                items = _driver_rows(self._collect_items(dataset))
                core = (
                    NearestNeighbors()
                    .setK(self.getOrDefault(self.k))
                    .setMetric(metric)
                    .fit(items)
                )
                model = TpuNearestNeighborsModel(core)
            model._set(
                k=self.getOrDefault(self.k),
                inputCol=self.getOrDefault(self.inputCol),
            )
            return model

    class TpuNearestNeighborsModel(_TpuNeighborsModelBase):
        pass

    class TpuApproximateNearestNeighbors(_TpuNeighborsBase):
        """ANN — the modern spark-rapids-ml ANN family. Algorithms pass
        through to the core model: ivfflat | ivfpq | brute |
        brute_approx (BASELINE.md config 7)."""

        algorithm = Param(
            Params._dummy(), "algorithm",
            "ivfflat|ivfpq|brute|brute_approx", TypeConverters.toString,
        )
        algoParams = Param(Params._dummy(), "algoParams", "algorithm parameters", TypeConverters.identity)

        def __init__(self, k=5, inputCol="features"):
            super().__init__()
            self._setDefault(k=5, inputCol="features", algorithm="ivfflat",
                             algoParams={}, indexMode="collected",
                             predictionCol="prediction",
                             featuresCol="features", labelCol="label")
            self._set(k=k, inputCol=inputCol)

        def setAlgorithm(self, value):
            return self._set(algorithm=value)

        def setAlgoParams(self, value):
            return self._set(algoParams=value)

        def _fit(self, dataset):
            from spark_rapids_ml_tpu_torch.neighbors import ApproximateNearestNeighbors

            if self.getOrDefault(self.indexMode) == "sharded":
                # Sharded executors search their shard exactly (numpy) —
                # the brute contract; inverted lists are resident
                # driver-card structures.
                if self.getOrDefault(self.algorithm) not in ("brute", "brute_approx"):
                    raise ValueError(
                        "indexMode='sharded' supports brute/brute_approx "
                        "(per-shard exact search + merge); inverted lists "
                        "need the collected driver-card index"
                    )
                shards = self._build_shards(dataset)
                model = TpuApproximateNearestNeighborsModel(
                    None, shards=shards, metric="euclidean"
                )
            else:
                items = _driver_rows(self._collect_items(dataset))
                core = (
                    ApproximateNearestNeighbors()
                    .setK(self.getOrDefault(self.k))
                    .setAlgorithm(self.getOrDefault(self.algorithm))
                    .setAlgoParams(dict(self.getOrDefault(self.algoParams)))
                    .fit(items)
                )
                model = TpuApproximateNearestNeighborsModel(core)
            model._set(
                k=self.getOrDefault(self.k),
                inputCol=self.getOrDefault(self.inputCol),
            )
            return model

    class TpuApproximateNearestNeighborsModel(_TpuNeighborsModelBase):
        pass

    class TpuDBSCAN(SparkEstimator, _TpuPredictorParams, _TpuEstimatorPersistence):
        """Density clustering (the modern spark-rapids-ml DBSCAN): fit
        computes labels for the TRAINING rows on the driver's card; the
        returned model's transform appends the cluster label column
        (-1 = noise) to the fitted dataset (cuML fit_predict semantics)."""

        eps = Param(Params._dummy(), "eps", "neighborhood radius", TypeConverters.toFloat)
        minSamples = Param(Params._dummy(), "minSamples", "core point threshold", TypeConverters.toInt)

        def __init__(self, featuresCol="features", predictionCol="prediction"):
            super().__init__()
            self._setDefault(
                eps=0.5, minSamples=5, featuresCol="features",
                labelCol="label", predictionCol="prediction",
            )
            self._set(featuresCol=featuresCol, predictionCol=predictionCol)

        def setEps(self, value):
            return self._set(eps=value)

        def setMinSamples(self, value):
            return self._set(minSamples=value)

        def _fit(self, dataset):
            from spark_rapids_ml_tpu_torch.clustering import DBSCAN

            x = _driver_rows(_collect_features(dataset, self.getOrDefault(self.featuresCol)))
            core = (
                DBSCAN()
                .setEps(self.getOrDefault(self.eps))
                .setMinSamples(self.getOrDefault(self.minSamples))
                .fit(x)
            )
            model = TpuDBSCANModel(core)
            for p in ("featuresCol", "predictionCol"):
                model._set(**{p: self.getOrDefault(getattr(self, p))})
            return model

    class TpuDBSCANModel(SparkModel, _TpuPredictorParams, _TpuCoreModelPersistence):
        def __init__(self, core_model=None):
            super().__init__()
            self._setDefault(
                featuresCol="features", labelCol="label", predictionCol="prediction"
            )
            self._core = core_model
            # (core, callable): rebuilt if _core is ever replaced.
            self._apply = None

        @property
        def labels_(self):
            return self._core.labels_

        def _transform(self, dataset):
            from pyspark.ml.functions import vector_to_array
            from pyspark.sql.functions import col

            if self._apply is None or self._apply[0] is not self._core:
                # Training rows must return the labels FIT assigned
                # (border assignment is expansion-order-dependent;
                # per-batch nearest-core re-prediction could relabel
                # them). Identical rows share identical epsilon-graph
                # adjacency, so a value lookup is exact for DBSCAN.
                # The lookup (training matrix + labels) ships as a
                # BROADCAST: one serialization total, a handle per task.
                bc = dataset.sparkSession.sparkContext.broadcast(
                    _FittedOrTransform(
                        np.asarray(self._core.fitted),
                        np.asarray(self._core.labels_, dtype=np.float64),
                        self._core.transform,
                    )
                )
                self._apply = (self._core, _BroadcastCall(bc))
            return dataset.withColumn(
                self.getOrDefault(self.predictionCol),
                _prediction_udf(self._apply[1])(
                    vector_to_array(col(self.getOrDefault(self.featuresCol)))
                ),
            )

        @staticmethod
        def _core_class():
            from spark_rapids_ml_tpu_torch.models.dbscan import DBSCANModel

            return DBSCANModel

    class TpuUMAP(SparkEstimator, _TpuPredictorParams, _TpuEstimatorPersistence):
        """Manifold embedding (the modern spark-rapids-ml UMAP): fit learns
        the layout on the driver's card; transform appends the embedding
        array column — training rows return their fitted coordinates, new
        rows embed against the frozen training layout."""

        nNeighbors = Param(Params._dummy(), "nNeighbors", "neighborhood size", TypeConverters.toInt)
        nComponents = Param(Params._dummy(), "nComponents", "embedding dimension", TypeConverters.toInt)
        nEpochs = Param(Params._dummy(), "nEpochs", "optimization epochs (0 = auto)", TypeConverters.toInt)
        seed = Param(Params._dummy(), "seed", "random seed", TypeConverters.toInt)
        outputCol = Param(Params._dummy(), "outputCol", "embedding column", TypeConverters.toString)
        buildAlgo = Param(
            Params._dummy(), "buildAlgo",
            "kNN graph build: brute (exact) | brute_approx (hardware top-k)",
            TypeConverters.toString,
        )

        def __init__(self, featuresCol="features", outputCol="embedding"):
            super().__init__()
            self._setDefault(
                nNeighbors=15, nComponents=2, nEpochs=0, seed=0,
                buildAlgo="brute",
                featuresCol="features", labelCol="label",
                predictionCol="prediction", outputCol="embedding",
            )
            self._set(featuresCol=featuresCol, outputCol=outputCol)

        def setNNeighbors(self, value):
            return self._set(nNeighbors=value)

        def setNComponents(self, value):
            return self._set(nComponents=value)

        def setNEpochs(self, value):
            return self._set(nEpochs=value)

        def setSeed(self, value):
            return self._set(seed=value)

        def setOutputCol(self, value):
            return self._set(outputCol=value)

        def setBuildAlgo(self, value):
            return self._set(buildAlgo=value)

        def _fit(self, dataset):
            from spark_rapids_ml_tpu_torch.manifold import UMAP

            core = (
                UMAP()
                .setNNeighbors(self.getOrDefault(self.nNeighbors))
                .setNComponents(self.getOrDefault(self.nComponents))
                .setNEpochs(self.getOrDefault(self.nEpochs))
                .setSeed(self.getOrDefault(self.seed))
                .setBuildAlgo(self.getOrDefault(self.buildAlgo))
                .fit(_driver_rows(_collect_features(dataset, self.getOrDefault(self.featuresCol))))
            )
            model = TpuUMAPModel(core)
            model._set(
                featuresCol=self.getOrDefault(self.featuresCol),
                outputCol=self.getOrDefault(self.outputCol),
            )
            return model

    class TpuUMAPModel(SparkModel, _TpuPredictorParams, _TpuCoreModelPersistence):
        outputCol = TpuUMAP.outputCol

        def __init__(self, core_model=None):
            super().__init__()
            self._setDefault(
                featuresCol="features", labelCol="label",
                predictionCol="prediction", outputCol="embedding",
            )
            self._core = core_model
            # (core, callable): rebuilt if _core is ever replaced.
            self._apply = None

        @property
        def embedding(self):
            return self._core.embedding

        def _transform(self, dataset):
            from pyspark.ml.functions import array_to_vector, vector_to_array
            from pyspark.sql.functions import col, pandas_udf

            if self._apply is None or self._apply[0] is not self._core:
                # Training rows return their FITTED coordinates (the
                # fit_transform semantics of the reference) even though
                # Arrow batches slice the dataset below the core model's
                # whole-array shortcut. Ships as a BROADCAST: one
                # serialization total, a handle per task.
                bc = dataset.sparkSession.sparkContext.broadcast(
                    _FittedOrTransform(
                        np.asarray(self._core.trainData),
                        np.asarray(self._core.embedding, dtype=np.float64),
                        self._core.transform,
                    )
                )
                self._apply = (self._core, _BroadcastCall(bc))
            apply = self._apply[1]

            @pandas_udf("array<double>")
            def embed(series):
                import pandas as pd

                if len(series) == 0:
                    return pd.Series([], dtype=object)
                block = np.stack(
                    [np.asarray(v, dtype=np.float64) for v in series]
                )
                return pd.Series(list(apply(block)))

            return dataset.withColumn(
                self.getOrDefault(self.outputCol),
                array_to_vector(
                    embed(vector_to_array(col(self.getOrDefault(self.featuresCol))))
                ),
            )

        @staticmethod
        def _core_class():
            from spark_rapids_ml_tpu_torch.models.umap import UMAPModel

            return UMAPModel

    class TpuRandomForestRegressor(SparkEstimator, _TpuPredictorParams, _TpuEstimatorPersistence):
        numTrees = Param(Params._dummy(), "numTrees", "number of trees", TypeConverters.toInt)
        maxDepth = Param(Params._dummy(), "maxDepth", "max tree depth", TypeConverters.toInt)
        maxBins = Param(Params._dummy(), "maxBins", "max feature bins", TypeConverters.toInt)
        seed = Param(Params._dummy(), "seed", "random seed", TypeConverters.toInt)
        subsamplingRate = Param(Params._dummy(), "subsamplingRate", "row sampling rate per tree", TypeConverters.toFloat)
        bootstrap = Param(Params._dummy(), "bootstrap", "sample with replacement", TypeConverters.toBoolean)
        featureSubsetStrategy = Param(Params._dummy(), "featureSubsetStrategy", "features considered per split", TypeConverters.toString)

        def __init__(self, featuresCol="features", labelCol="label"):
            super().__init__()
            self._setDefault(
                numTrees=20, maxDepth=5, maxBins=32, seed=0,
                subsamplingRate=1.0, bootstrap=True,
                featureSubsetStrategy="auto",
                featuresCol="features", labelCol="label",
                predictionCol="prediction",
            )
            self._set(featuresCol=featuresCol, labelCol=labelCol)

        def setNumTrees(self, value):
            return self._set(numTrees=value)

        def setMaxDepth(self, value):
            return self._set(maxDepth=value)

        def setMaxBins(self, value):
            return self._set(maxBins=value)

        def setSeed(self, value):
            return self._set(seed=value)

        def setSubsamplingRate(self, value):
            return self._set(subsamplingRate=value)

        def setBootstrap(self, value):
            return self._set(bootstrap=value)

        def setFeatureSubsetStrategy(self, value):
            return self._set(featureSubsetStrategy=value)

        def _fit(self, dataset):
            from spark_rapids_ml_tpu_torch.models.random_forest import (
                RandomForestRegressionModel,
            )

            rdd = dataset.select(
                self.getOrDefault(self.featuresCol),
                self.getOrDefault(self.labelCol),
            ).rdd
            forest, d, _ = _fit_forest_rdd(
                rdd,
                n_trees=self.getOrDefault(self.numTrees),
                max_depth=self.getOrDefault(self.maxDepth),
                max_bins=self.getOrDefault(self.maxBins),
                seed=self.getOrDefault(self.seed),
                impurity="variance",
                classification=False,
                subsampling_rate=self.getOrDefault(self.subsamplingRate),
                bootstrap=self.getOrDefault(self.bootstrap),
                feature_subset=self.getOrDefault(self.featureSubsetStrategy),
            )
            core = RandomForestRegressionModel(None, forest, numFeatures=d)
            model = TpuRandomForestRegressionModel(core)
            for p in ("featuresCol", "labelCol", "predictionCol"):
                model._set(**{p: self.getOrDefault(getattr(self, p))})
            return model

    class TpuRandomForestRegressionModel(SparkModel, _TpuPredictorParams, _TpuCoreModelPersistence):
        def __init__(self, core_model=None):
            super().__init__()
            self._setDefault(
                featuresCol="features", labelCol="label", predictionCol="prediction"
            )
            self._core = core_model

        def _transform(self, dataset):
            import functools

            from pyspark.ml.functions import vector_to_array
            from pyspark.sql.functions import col

            from spark_rapids_ml_tpu_torch.core.lazy_state import to_host
            from spark_rapids_ml_tpu_torch.models.random_forest import _forest_depth
            from spark_rapids_ml_tpu_torch.spark import executor_math

            f = self._core._forest
            forward = functools.partial(
                executor_math.forest_forward_reg,
                to_host(f.feature),
                to_host(f.threshold, np.float64),
                to_host(f.is_leaf),
                to_host(f.leaf_value, np.float64),
                _forest_depth(f),
            )
            return dataset.withColumn(
                self.getOrDefault(self.predictionCol),
                _prediction_udf(forward)(
                    vector_to_array(col(self.getOrDefault(self.featuresCol)))
                ),
            )

        @staticmethod
        def _core_class():
            from spark_rapids_ml_tpu_torch.models.random_forest import RandomForestRegressionModel

            return RandomForestRegressionModel
