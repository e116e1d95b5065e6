#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``spark_rapids_ml_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every hand-written kernel from ``spark_rapids_ml_tpu_torch/csrc``
(one ``nvcc`` per source, all started together), holds each against its
plain PyTorch version and a float64 reference on the card, and drives the
port's three paths through their public entry points, each with the launch
counters set to 0 just before and read just after:

- PCA: ``PCA().setK(16)`` fit and transform on a 1M x 1024 float32
  tensor, a fit over four host partitions, a save/load round trip;
- KMeans at BASELINE.md config 3's shape (20M x 16 float32, k = 100, on
  planted blobs made on the card from the seed): ``KMeans().setK(100)``
  and ``setK(16)`` fits (kernels K2 and K3), predict and transform on all
  rows, a save/load round trip, held against the ``xla`` route and a
  float64 fit from the same initial centers;
- UMAP at BASELINE.md config 13's shape (50,000 x 64 float32 -> 2-D,
  nNeighbors 15, 200 epochs, random init, pool of 256, on planted blobs):
  ``UMAP().fit`` (kernel K4 every epoch), ``transform`` of 10,000 new
  rows, a save/load round trip; held against an on-card float64 kNN,
  the plain tail route (one epoch, and trustworthiness of a whole fit),
  and the blobs; then a spectral-init fit at 8,192 rows;
- wide and streaming fits, which run none of the kernels' own paths:
  ``PCA().setK(16)`` on a 262,144 x 8,192 float32 tensor (``solver``
  auto takes the randomized sketch), held against the same sketch in
  float64 and an exact float64 eigensolve, and timed beside the
  covariance fits (K1 at d = 8,192 under ``pallas``); the same rows as 32
  host blocks through an iterator factory (the streaming sketch); PCA
  over 2,097,152 x 1,024 float32 rows as 32 host blocks (a one-shot
  generator and a factory: the one-pass streaming covariance) and its
  streaming transform, against an on-card float64 fit; KMeans at config
  3's shape as 20 host blocks through a factory (streaming Lloyd),
  warm-started against the in-memory fit and seeded from its reservoir
  against the planted blobs;
- linear, logistic and evaluation at BASELINE configs 4, 10 and 14, which
  launch no kernel: ``LinearRegression().setRegParam(0.1)`` on 11M x 28
  float32 rows (also its elastic net, its ``dd`` route over 11 host blocks,
  predict and evaluate), held against a float64 solve of float64 moments;
  ``LogisticRegression().setRegParam(0.01).setMaxIter(20).setTol(0.0)`` on
  the same shape (also 3-class multinomial, elastic net, the streaming fit
  over 11 host blocks, predict), held against float64 copies and a
  converged float64 fit; the three evaluators on 10M rows on the card,
  held against their host route in float64;
- the fit policy, which adds no kernel (its UMAP fits count K4's
  launches under each ``TPUML_UMAP_SCATTER`` route):
  ``PCA().setK(16).setUseGemm(False)`` on 4 host float64 partitions of
  65,536 × 128 (the native spr accumulator, built with g++ from
  ``native/src/tpuml_host.cpp``) and the same rows as a ``.npy`` through
  ``NpyBlockReader`` (packed and GEMM streaming routes), against an
  on-card float64 fit; the fit memory guard: a 4 GiB host PCA over a
  1 GiB budget degrades, bit for bit the explicit block-reader fit, a real
  OOM under a ballast is recovered to the same fit once the failed
  attempt's memory is freed, KMeans / linear / logistic at configs 3, 4
  and 10's shapes degrade under 256 MiB (bit for bit), ``fused`` KMeans
  and UMAP are refused, and with no budget set the earlier phases' one
  host-input fit was admitted; the knobs ``TPUML_PRECISION_PCA``,
  ``TPUML_UMAP_SCATTER`` and ``TPUML_LOGISTIC_FUSED`` against their
  explicit twins; and (f) a 4 GiB float32 CUDA tensor that meets a real
  OOM, copied to the host and streamed, bit for bit the explicit
  block-reader fit of its host copy;
- the neighbours, last, which launch no kernel, on data planted on the
  card and within their own 60 s: BASELINE config 11,
  ``NearestNeighbors().setK(10)`` on 1M x 96 float32 items and 10,000
  queries (euclidean, cosine) against an on-card float64 brute force,
  with a profile split of the search into GEMM, int64 key build, ``topk``
  and the rest; config 7, ``ApproximateNearestNeighbors`` with ``brute``,
  ``brute_approx`` and ``ivfflat`` (nlist 1,024, nprobe 32; the
  quantizer's row-blocked assignment; nprobe = nlist exact on 1,000
  queries); an ``ivfflat`` save and load rebuilding the same index;
  config 8, ``ivfpq`` on 1M x 128 items and 2,000 queries (uint8 codes,
  ADC against float64, ``refine_ratio`` 4) and a streamed brute index
  over host blocks against the resident one;
- DBSCAN and the random forest, last, which launch no kernel, on data
  drawn on the card and within their own 60 s: BASELINE config 12,
  ``DBSCAN().setEps(2.0).setMinSamples(8)`` on 100,000 x 16 float32 rows of
  20 planted blobs, held to the float64 fit of the same rows (and 10,000
  new rows through ``transform``), with a profile split into distance
  GEMMs, the adjacency epilogue and the label passes; the 100,000-point
  chain in float64 (one cluster in at most 4 sweeps; float32 recorded);
  config 9, ``RandomForestClassifier`` (8 trees, depth 6, 16 bins,
  ``setNumClasses(2)``) on 500,000 x 16 float32 rows, its trees bitwise
  the same fit with histograms summed in float64, split into histogram
  GEMMs, one-hot builds, split search and routing; the regressor at the
  same shape (RMSE within 1 % of its float64-histogram fit); save and load
  of the classifier (bitwise) and of a 10,000-row DBSCAN model.
- composition, last, within its own 60 s, on data drawn on the card:
  (a) ``Pipeline([PCA().setK(8), KMeans().setK(100)])`` on config 3's
  20M x 16 float32 blobs (K2 in the KMeans stage), its fused transform
  bitwise the staged loop's and equal to a float64 projection and
  assignment off a named margin band; (b) ``CrossValidator`` (3 folds x
  regParam 0.001 / 0.01 / 0.1) over PCA(16, ``pallas``) -> logistic on
  config 10's 11M x 28 float32 pair (device folds, 10 K1 launches, no
  host copy of x by a count of aten's copies, every avgMetrics entry
  within 1e-4 of a float64 re-evaluation of its fold model, bestModel
  bitwise a fresh fit of the best map); (c) ``TrainValidationSplit``
  over the logistic family with the AUC, within 1e-6 of the host route;
  (d) config 10's rows as a host array through (b)'s model, fused and
  staged bitwise, with walls and copy bytes, and 32-row requests;
  (e) save and load of (a)'s and (b)'s models, predicting bitwise.
- serving, last, within its own 60 s (configs 15, 3, 16 and 10): (a) the
  bucket ladder: config 15's ``PCAModel`` (1024 -> 16, float32 components
  from the seed) and config 3's ``KMeansModel`` (k = 100 over 16) on
  float32 device batches of 1 to 65,536 rows, twice, one CUDA graph per
  bucket (captures = buckets), each output bitwise the eager kernel on the
  same padded bucket and held to float64, with the replay and the eager
  call timed per bucket; (b) a 1M x 1,024 float32 device batch (eager
  above the capture bound) beside its bytes bound, and the same rows as
  host blocks through the pinned double-buffered stream against a
  pageable copy loop, with the share of copy and compute overlap; (c)
  config 16's closed loop, 16 threads x 150 single rows through a
  ``ServingRuntime``, unbatched and batched; (d) config 10's fused PCA(16)
  -> logistic ``PipelineModel`` as one servable, 200 requests of 32 rows,
  bitwise its ``transform``; (e) a hot swap under 4 threads, ``retire``
  freeing its weights and graphs, queue and byte shedding, a deadline,
  a drain.
- the mesh and multi-process routes, last, within their own 120 s, with
  no fallback to the CPU or to one device and none of the kernels (the
  reference's mesh routes reach no Pallas kernel): (a) config 5's width,
  ``PCA(mesh=...).setK(16)`` on a 1,048,576 x 1,024 float32 tensor over a
  (1, 1) mesh and a (4, 1) mesh of the one card, and the same rows as 4
  host partitions through ``shard_rows_from_partitions``, held to the
  float64 and single-device fits, K1 not launched, ``pallas`` refused;
  (b) config 5's block step, ``streaming_mean_and_covariance_mesh`` over
  2,000,000 x 1,024 float32 rows as 2 host blocks, with the H2D share of
  its window; (c) two processes on the one card (gloo with CUDA tensors;
  the script starts itself as ``--mesh-rank R``): gang PCA, the streamed
  covariance with both merges, gang logistic at config 10's shape, ranks
  bitwise equal and held to one-process fits; then an NCCL world of one
  equal bit for bit to (a)'s (1, 1) fit; (d) KMeans (config 3), linear
  (config 4) and logistic (config 10) on (4, 1) and (2, 2) meshes against
  their single-device and float64 fits.
- robustness, last, within its own 60 s, on data drawn on the card from
  its own seed: (a) a host PCA fit (262,144 x 1,024, ``pallas``) under
  ``ingest.device_put=2`` bitwise the clean fit with 2 failed attempts
  counted and K1 launched as in one fit; under ``always`` one
  ``RetryExhaustedError`` and the device memory back; under ``:fatal``
  one attempt; config 3's rows on the host, degraded to the streaming
  KMeans fit, recovering from ``solver.segment=1:oom`` bitwise the explicit
  reader fit of the halved blocks; (b) a save under
  ``persistence.write=1`` round-tripping bitwise, and an overwrite killed
  midway leaving the previous model; (c) configs 3 (KMeans k = 100,
  ``xla``), 4 (elastic-net FISTA), 10 (L-BFGS) and 13 (UMAP, K4 every
  epoch) checkpointed: segmented bitwise the monolithic fit, a fit killed
  at its first segment boundary resumed bitwise with fewer iterations,
  K4's 200 launches across the killed and the resumed layout; (d) a child
  process (``--robust-child``) frozen at its first segment boundary and
  SIGKILLed, its snapshot resumed here bitwise.
- the continuous-training lifecycle, last, within its own 60 s, on data
  drawn on the card from its own seeds: (a) config 5's width, a 1,048,576
  x 1,024 float32 tensor folded by ``PCA.partial_fit`` in 4 calls of
  262,144 rows through K1's float64 route (one launch a call, as its plan
  says), the merged moments within 1e-12 of one call, the fit within 1e-5
  (components) and 1e-6 (ratios) of an on-card float64 fit, the previous
  moments untouched; (b) config 3: the incumbent fitted on ``auto`` (K2, 3
  launches), then ``partial_fit`` on 2,000,000 fresh rows warm-seeded from
  it, with strictly fewer solver iterations than the cold call, which is
  bitwise an ``xla`` fit; (c) configs 4 and 10 likewise, warm within 1e-4
  of cold; (d) a ``LifecycleController`` over a started ``ServingRuntime``:
  a ``DriftMonitor`` fed from served distances quiet, then firing on
  shifted blobs; a drifted cycle flipping to version 2 under single-row
  traffic (every response attributed, none shed), a gated cycle rejected,
  ``watch`` rolling back to version 1; (e) a child controller
  (``--lifecycle-child``) SIGKILLed in its refit stage, its cycle resumed
  here with one registered version and centres bitwise an uninterrupted
  cycle's.
- the cost ledger and the autotuner, group (p), within its own 60 s,
  with ``TPUML_PEAK_FLOPS`` / ``TPUML_PEAK_BYTES_PER_SEC`` at the card's
  fp32 and HBM peaks: (a) config 5's ``pallas`` PCA fit and transforms
  under ``TPUML_COST_LEDGER=1``, bitwise the unledgered ones with as many
  K1 launches, every entry's flops its analytic count, every roofline
  utilization at most 1, device time (CUDA events) beside host enqueue
  time, and the HBM sampler naming the span where a 4 GiB host input grew
  the peak; (b) configs 15 and 3's bucket ladders under the ledger (no
  retrace), a wandering batch size on a cache of two (eviction refills),
  a seeded bucket bypass (one ``RetraceStormWarning``), measured bytes
  within [output bytes, the graph pool], measured admission, and a
  replay's host wall with the ledger off and on; (c) config 16's runtime
  under ``TPUML_AUTOTUNE=on``: an exact rung for a hot 12-row batch,
  bitwise the eager kernel, the batcher's window from measured walls,
  rows/s off and on; (d) streaming KMeans and PCA under a 256 MiB budget
  on the tuner's block rows, an injected OOM halving once into the store,
  each bitwise its explicit reader fit; (e) the precision gate's probe on
  the card, and a second process (``--tune-child``) reading its decision;
  (a) also holds ``mean center``'s peak growth to the placed block.
- the lock sanitizer and the ops plane, last, group (q), within its own
  60 s: the same work here with the sanitizer off and in a child
  (``--opsplane-child``) under ``TPUML_LOCKCHECK=strict`` with its ops
  server on an ephemeral port, the cost ledger on in both, bitwise alike:
  (a) config 5's ``pallas`` PCA fit (K1) and config 3's KMeans (K2, 3
  launches); (b) config 15's bucket ladder and config 16's closed loop,
  unbatched and batched, rows/s off and under ``strict``, no violation,
  the order graph acyclic when read back from the child's exit dump,
  ``lockcheck.hold_ms`` labelled by the serving locks; (c) a scraper on
  ``/metrics``, ``/varz``, ``/healthz`` and ``/tracez`` every 50 ms during
  config 16's batched loop: every answer 200 and carrying the runtime and
  the ledger's ``covariance.gram`` family, the scrape latency and the
  rows/s with and without it; (d) ``/healthz`` flips on a failing probe,
  a stale manual heartbeat and a stall strike on a wedged registry (one
  event, one flight dump showing both threads, the waiter served).
- the Spark layer, group (r), within its own 120 s, through the repo's
  pyspark stub (``tests/pyspark_stub``: numpy, pandas, pyarrow and
  cloudpickle; the group fails without pandas, which the stub's
  ``pandas_udf`` needs), widths uncut and rows cut where the stub's
  one-object-per-row DataFrame needs it: (a) the discovery script's
  addresses are ``nvidia-smi``'s, and a child (``--spark-child``) that
  ``bringup_executor`` pins joins an NCCL world of one and fits config 5's
  PCA on ``global_mesh()`` bitwise its (1, 1) mesh fit; (b) ``TpuPCA`` at
  config 5's 1,024 features, the driver's ``eigh`` on ``cuda:0``, against
  a float64 oracle and the host eigensolve at 1e-9; (c) ``TpuKMeans`` at
  config 3, its centres within 1e-9 of a plain float64 Lloyd from the
  same seeding, and ``TpuLinearRegression`` at config 4 (its elastic net
  refused); (d) ``TpuLogisticRegression`` at config 10 through
  ``gang_fit``, bitwise the (1, 1) mesh fit; (e) config 9's forest,
  configs 11 and 7's kNN and ANN and config 12's DBSCAN, each equal to
  the port's direct fit; (f) ``TpuUMAP`` at config 13 uncut, K4 200
  times, the layout bitwise a direct fit; (g) ``barrier.attempt=1``
  refits bitwise, and a checkpointed ``gang_fit`` of config 4's elastic
  net resumes mid-solve to the uninterrupted result. Each adapter fit's
  wall prints beside the direct fit's, and its kernels' launches are
  counted (``launches_spark`` in the ``kernels`` line).
- the distributed serving tier, group (s), within its own 120 s, its
  members spawned on ``cuda`` by the router (the platform on their
  command line) and each exiting with its router or after 60 s without
  one: (a) config 18 (``benchmarks/config18_router.py``) uncut, KMeans
  k = 32 over 64 features to 8 closed-loop threads x 40 requests x 64
  rows through gangs of 1, 2 and 4 members on the one card: rows/s of
  each, the scaling from 1 to 4 (the reference's 0.4 floor gated, its 3x
  bound recorded), every request completed, every member used, every
  answer bitwise the model's predict on dyadic rows; on a 2-member gang
  whose members admit 1 MiB each: (b) a hot swap under config 16's
  closed loop (16 threads of single rows): nothing shed, every answer
  its attributed version's, each caller's versions in order, a local
  first/last table per version; (c) a 16,387-row request refused by
  every member's budget, run on the router's sharded route (the default
  mesh and a 4-shard mesh of the card) bitwise the members' answers in
  64-row requests; (d) a ``LifecycleController`` cycle on config 5's PCA
  (262,144 x 1,024 rows), its refit's K1 launches counted
  (``launches_serving``), the flip on both members, a routed transform
  against the model's; (e) an ``ElasticScaler`` join and retire under
  load shedding nothing, and a member frozen by the stall grammar
  retired by its heartbeat age, its parked requests answered elsewhere.
- the sharded families in a gang, group (t), within its own 120 s: two
  ranks on the one card (gloo with CUDA tensors; the script starts
  itself as ``--gs-rank``), each holding the whole matrices uncut, fit
  config 11's kNN, config 7's ``brute`` ANN (its ``ivfflat`` refused, as
  the reference's IVF build fails in a gang), config 13's UMAP, config
  12's DBSCAN and config 9's two forests with ``setDeployMode("gang")``;
  this process then fits the same on a (2, 1) mesh of the card, each fit
  twice (a fresh process's first calls, then the steady fit). UMAP fits
  in the default mode users run, then in a labelled deterministic pass.
  The ranks are bitwise equal; every fit but the default-mode UMAP is
  bitwise the (2, 1) fit and each second fit bitwise its first; the
  default-mode UMAP, whose scatter's atomics sum in no fixed order, keeps
  the (2, 1) fit's trustworthiness within 0.03. Both walls print beside
  the one-process walls with the bytes the fit gathered, and K1-K4 launch
  in no rank (``launches_gang`` in the ``kernels`` line).

It times the kernels beside their bounds and profiles one fit of each
path (device time by kernel, the device's idle share). It fails if
``ptxas`` reports a register spill in any kernel's build. Each phase prints
one JSON line; the ``kernels`` line and the card's ``nvidia-smi`` name and
power limit come before the last line, which is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without CUDA, or
a directory without the package. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import pickle
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from spark_rapids_ml_tpu_torch import device as port_device  # noqa: E402
from spark_rapids_ml_tpu_torch.feature import PCA, PCAModel  # noqa: E402
from spark_rapids_ml_tpu_torch.ops.kernels import _build  # noqa: E402
from spark_rapids_ml_tpu_torch.ops.eigh import auto_max_iters, eigh_auto  # noqa: E402
from spark_rapids_ml_tpu_torch.ops.kernels import covariance as k1  # noqa: E402
from spark_rapids_ml_tpu_torch.ops.kernels import kmeans as kk  # noqa: E402
from spark_rapids_ml_tpu_torch.clustering import DBSCAN, DBSCANModel, KMeans, KMeansModel  # noqa: E402
from spark_rapids_ml_tpu_torch.ops import kmeans as ops_kmeans  # noqa: E402
from spark_rapids_ml_tpu_torch.utils.testing import kmeans_stats_f64, trustworthiness  # noqa: E402
from spark_rapids_ml_tpu_torch.manifold import UMAP, UMAPModel  # noqa: E402
from spark_rapids_ml_tpu_torch.models.umap import _knn_excluding_self  # noqa: E402
from spark_rapids_ml_tpu_torch.ops import umap as ops_umap  # noqa: E402
from spark_rapids_ml_tpu_torch.ops.kernels import umap as k4  # noqa: E402
from spark_rapids_ml_tpu_torch.ops.eigh import sign_flip  # noqa: E402
from spark_rapids_ml_tpu_torch.ops.randomized import draw_omega, randomized_pca  # noqa: E402
from spark_rapids_ml_tpu_torch.utils.tracing import clear_counters, counter_value, counters  # noqa: E402
from spark_rapids_ml_tpu_torch.observability import autotune as port_autotune  # noqa: E402
from spark_rapids_ml_tpu_torch.observability import costs as port_costs  # noqa: E402
from spark_rapids_ml_tpu_torch.regression import LinearRegression, RandomForestRegressor  # noqa: E402
from spark_rapids_ml_tpu_torch.classification import (  # noqa: E402
    LogisticRegression,
    RandomForestClassificationModel,
    RandomForestClassifier,
)
from spark_rapids_ml_tpu_torch import native  # noqa: E402
from spark_rapids_ml_tpu_torch.core import membudget  # noqa: E402
from spark_rapids_ml_tpu_torch.core.data import HostArrayBlockReader, fit_block_rows  # noqa: E402
from spark_rapids_ml_tpu_torch.robustness import InjectedFault, RetryExhaustedError, inject  # noqa: E402
from spark_rapids_ml_tpu_torch.robustness.degrade import DegradationWarning  # noqa: E402
from spark_rapids_ml_tpu_torch.neighbors import (  # noqa: E402
    ApproximateNearestNeighbors,
    ApproximateNearestNeighborsModel,
    NearestNeighbors,
)
from spark_rapids_ml_tpu_torch.evaluation import (  # noqa: E402
    BinaryClassificationEvaluator,
    MulticlassClassificationEvaluator,
)
from spark_rapids_ml_tpu_torch.pipeline import Pipeline, PipelineModel  # noqa: E402
from spark_rapids_ml_tpu_torch.parallel import distributed as gang  # noqa: E402
from spark_rapids_ml_tpu_torch.ops import covariance as ops_covariance  # noqa: E402
from spark_rapids_ml_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from spark_rapids_ml_tpu_torch.tuning import (  # noqa: E402
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    TrainValidationSplit,
)

SEED = 0
N_MAIN = 1_000_000          # rows of the main path (bench.py's width: 1M x 1024)
N_RAGGED = 1_000_003        # the kernel check's ragged row count
D = 1024
K = 16
HOST_PARTS = 4
HOST_ROWS = 65_536
REPEATS = 10

# KMeans: BASELINE.md config 3's shape (NYC-Taxi 20M rows x 16, k = 100);
# the data is not in the repo, so blobs are planted at that shape.
KM_N = 20_000_000
KM_D = 16
KM_K = 100
KM_K_PACKED = 16            # the same tensor at k = 16 is packable: K3
KM_BLOCK = 1 << 20          # rows per block of the plain and float64 references
KM_SCALE = 50.0             # blob centers ~ N(0, 50^2), unit noise
KM_MODES = ("highest", "high", "default")

# UMAP: BASELINE.md config 13 (benchmarks/config13_umap.py: 50k x 64 -> 2-D,
# nNeighbors 15, 200 epochs, random init, brute_approx); the config's data
# is N(0, 1), which has no structure to check, so blobs are planted at
# that shape.
UM_N = 50_000
UM_D = 64
UM_K = 15
UM_DIM = 2
UM_EPOCHS = 200
UM_BLOBS = 10
UM_SCALE = 3.0              # blob centers ~ N(0, 3^2) per feature, unit noise
UM_NEW = 10_000             # rows for transform
UM_SUB = 2_000              # rows of the trustworthiness subsample
UM_KNN_Q = 2_048            # query rows of the float64 kNN check
UM_SPECTRAL_N = 8_192       # the largest n the estimator gives spectral init

# Wide and streaming fits. WIDE_D is twice the width at which solver "auto"
# takes the randomized sketch (4,096); the streaming fits cut no widths.
WIDE_N = 262_144
WIDE_D = 8_192
WIDE_BLOCK = 8_192          # rows per host block of the streaming sketch (32 blocks)
ST_N = 2_097_152            # rows of the streaming covariance fit (32 blocks of HOST_ROWS)
KM_ST_BLOCK = 1 << 20       # rows per host block of the streaming KMeans fit (20 blocks)
ORACLE_CHUNK = 16_384       # rows per chunk of the float64 Gram of the wide rows

#: Every kernel of the paths: (name, route, source, the TPU kernel it replaces).
KERNELS = [
    ("centered_gram", "cuda", "spark_rapids_ml_tpu_torch/csrc/centered_gram.cu",
     "spark_rapids_ml_tpu/ops/pallas/covariance.py:49"),
    ("assign_stats_fused", "cuda", "spark_rapids_ml_tpu_torch/csrc/kmeans_assign_stats.cu",
     "spark_rapids_ml_tpu/ops/pallas/kmeans.py:129"),
    ("assign_stats_packed", "cuda", "spark_rapids_ml_tpu_torch/csrc/kmeans_assign_packed.cu",
     "spark_rapids_ml_tpu/ops/pallas/kmeans.py:258"),
    ("tail_accumulate", "cuda", "spark_rapids_ml_tpu_torch/csrc/umap_tail.cu",
     "spark_rapids_ml_tpu/ops/pallas/umap.py:162"),
]

#: Published peaks (NVIDIA data sheets, dense, no sparsity): HBM bytes/s,
#: fp32 FLOP/s outside the tensor cores, and fp64 FLOP/s at the tensor-core
#: (DMMA) rate, the card's fastest for that type. Matched on the name
#: nvidia-smi reports; the first match wins.
PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12, 60e12),
    ("H200", 4.8e12, 67e12, 67e12),
    ("H100", 3.35e12, 67e12, 67e12),  # SXM
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {what}")


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, repeats: int = REPEATS, warmup: int = 2) -> float:
    """Median device time of ``fn()`` over ``repeats`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        sync()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls: int = 50, replays: int = 5) -> float:
    """Device time per call of ``fn()``: ``calls`` calls captured in one
    CUDA graph, the median of ``replays`` timed replays over ``calls``.
    For a call of a few microseconds, whose eager time is the host's
    Python and launch path rather than the card's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    sync()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        sync()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def wall_s(fn, repeats: int = 3) -> float:
    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def peaks_for(name: str):
    for key, hbm, fp32, fp64 in PEAKS:
        if key in name:
            return key, hbm, fp32, fp64
    return "H100 (name not matched; SXM peaks)", 3.35e12, 67e12, 67e12


#: The one PyTorch call that computes K1's function, timed beside it.
LIBRARY_GRAM = "b = x - mean; torch.matmul(b.T, b)"


def gram_bound_ms(n: int, d: int, dtype: torch.dtype, peaks) -> tuple:
    """Least time for the centered Gram: each input read once, the output
    written once, over HBM; n·d·(d+1) flops (the symmetric half, two per
    FMA) over the type's peak outside the tensor cores."""
    _, hbm, fp32, fp64 = peaks
    item = 4 if dtype == torch.float32 else 8
    bytes_ms = (n * d + d + d * d) * item / hbm * 1e3
    ops_ms = n * d * (d + 1) / (fp32 if dtype == torch.float32 else fp64) * 1e3
    return max(bytes_ms, ops_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def planted(n: int, d: int, gen: torch.Generator) -> torch.Tensor:
    """x = z·diag(s)·Qᵀ + μ on the card: a geometrically decaying top 32
    (s_i = 1 + 30·0.8^i) over unit noise, so the top-16 eigenvectors are
    well determined (a flat Marchenko–Pastur spectrum would not be)."""
    dev = torch.device("cuda")
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=gen, device=dev, dtype=torch.float64))
    s = torch.ones(d, dtype=torch.float64, device=dev)
    s[:32] += 30.0 * 0.8 ** torch.arange(32, dtype=torch.float64, device=dev)
    mu = 3.0 * torch.randn(d, generator=gen, device=dev, dtype=torch.float64)
    z = torch.randn((n, d), generator=gen, device=dev, dtype=torch.float32)
    z.mul_(s.float())
    x = z @ q.T.float()
    del z
    x.add_(mu.float())
    return x


def f64_gram(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    b = x.double() - mean.double()
    return b.T @ b


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    stems = [os.path.splitext(os.path.basename(source))[0] for _, _, source, _ in KERNELS]
    build_s = _build.build_all(stems)
    ptxas = {
        stem: [ln.split("info    : ")[-1] for ln in _build.build_logs.get(stem, "").splitlines()
               if "registers" in ln or "spill" in ln]
        for stem in stems
    }
    spills = {stem: sum(int(v) for ln in lines for v in re.findall(r"(\d+) bytes spill", ln))
              for stem, lines in ptxas.items()}
    for stem in ("kmeans_assign_stats", "kmeans_assign_packed"):
        for line in ptxas_by_function(_build.build_logs.get(stem, "")):
            print(f"ptxas {stem} {line}", flush=True)
    info = {
        "phase": "device",
        "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "sms": torch.cuda.get_device_properties(0).multi_processor_count,
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_s": build_s,
        "ptxas": ptxas,
        "spill_bytes": spills,
    }
    emit(info)
    for stem in stems:
        require(spills[stem] == 0, f"{stem} spills registers: {ptxas[stem]}")
    return info


def ptxas_by_function(log: str) -> list:
    """One line per kernel of an nvcc -Xptxas -v log: the kernel (a K2 or
    K3 instantiation by its template arguments, as K2's <dreg, prec[,
    vec]> and K3's <dg, prec, vec>), its registers and its spill stores
    and loads."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"(assign_[a-z_]+)I((?:L[ib]\d+E)+)E", ln)
            if m:
                args = [v if kind == "i" else ("true" if v == "1" else "false")
                        for kind, v in re.findall(r"L([ib])(\d+)E", m[2])]
                name = f"{m[1]}<{', '.join(args)}>"
            else:
                name = re.search(r"'([^']*)'", ln)[1][:60]
        elif "bytes spill" in ln and name:
            spill = ln.split("info    : ")[-1].strip()
        elif "Used" in ln and name:
            out.append(f"{name}: {ln.split('info    : ')[-1].strip()}; {spill}")
            name = None
    return out


def phase_kernel_check(x_big: torch.Tensor, gen: torch.Generator) -> dict:
    """K1 and its plain version against an on-card float64 Gram."""
    dev = torch.device("cuda")
    cases = [
        ("f32", x_big),
        ("f32", torch.randn((4099, 130), generator=gen, device=dev) + 2.0),
        ("f32", torch.randn((37, 5), generator=gen, device=dev) - 1.0),
        ("f64", x_big[:65_536].double()),
    ]
    results = []
    main_abs_err = None
    for kind, x in cases:
        mean = x.mean(dim=0)
        got = k1.centered_gram_cuda(x, mean)
        again = k1.centered_gram_cuda(x, mean)
        plain = k1.centered_gram_plain(x, mean)
        ref = f64_gram(x, mean)
        scale = ref.abs().max().item()
        err = (got.double() - ref).abs().max().item() / scale
        plain_err = (plain.double() - ref).abs().max().item() / scale
        vs_plain = (got - plain).abs().max().item()
        tol = 1e-4 if kind == "f32" else 1e-12
        row = {
            "shape": list(x.shape), "dtype": kind, "tol": tol,
            "kernel_rel_err": err, "plain_rel_err": plain_err,
            "kernel_vs_plain_max_abs": vs_plain,
            "symmetric": bool(torch.equal(got, got.T)),
            "bitwise_repeat": bool(torch.equal(got, again)),
        }
        if x is x_big:
            # The library call of the times phase, b = x − μ; bᵀb in IEEE
            # fp32 (cuBLAS, TF32 off), against the same float64 Gram.
            b = x - mean
            row["library_rel_err"] = (torch.matmul(b.T, b).double() - ref).abs().max().item() / scale
            del b
            require(err <= row["library_rel_err"],
                    f"K1 error {err:.3e} above the library call's {row['library_rel_err']:.3e}")
            main_abs_err = vs_plain
        results.append(row)
        require(err <= tol, f"K1 {kind} {list(x.shape)} error {err:.3e} > {tol:.0e}")
        require(plain_err <= tol, f"plain {kind} {list(x.shape)} error {plain_err:.3e} > {tol:.0e}")
        require(row["symmetric"], f"K1 {kind} {list(x.shape)} output not symmetric")
        require(row["bitwise_repeat"], f"K1 {kind} {list(x.shape)}: a repeat launch differs")
        del got, again, plain, ref
    out = {"phase": "kernel_check", "cases": results, "main_max_abs_err": main_abs_err}
    emit(out)
    return out


def _pc_err(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max())


def _ev_rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def phase_main_path(xm: torch.Tensor, parts: list) -> dict:
    """The port's main path through its public entry points, with the
    launch counters set to 0 just before and read just after."""
    k1.reset_launches()
    t0 = time.perf_counter()
    model = PCA().setK(K).setCovarianceBackend("pallas").fit(xm)
    pc, ev = model.pc, model.explainedVariance
    fit_device_s = time.perf_counter() - t0
    after_device_fit = k1.launches
    y = model.transform(xm)
    sync()
    model_h = PCA().setK(K).setCovarianceBackend("pallas").fit(parts)
    pc_h = model_h.pc
    after_host_fit = k1.launches
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pca_model")
        model.write.overwrite().save(path)
        loaded = PCAModel.load(path)
        pc_loaded = loaded.pc
        y_loaded = loaded.transform(xm[:1000])
    launches = {"centered_gram": k1.launches}

    require(after_device_fit >= 1, "device-tensor fit did not launch K1")
    require(after_host_fit - after_device_fit >= HOST_PARTS, "host-partition fit did not launch K1 per partition")
    require(np.array_equal(pc_loaded, pc), "save/load changed the components")
    require(loaded.getCovarianceBackend() == "pallas" and loaded.getK() == K, "save/load lost params")

    # References, outside the counted window: the "xla" route on the same
    # tensor, and a float64 fit on the card.
    model_xla = PCA().setK(K).fit(xm)
    x64 = xm.double()
    model_64 = PCA().setK(K).fit(x64)
    # transform is held against x @ pc with the model's own components, in
    # float64: the fit itself is held against the references above.
    ref_y = x64 @ torch.from_numpy(pc).cuda()
    y_rel = ((y.double() - ref_y).abs().max() / ref_y.abs().max()).item()
    y_loaded_rel = ((y_loaded.double() - ref_y[:1000]).abs().max() / ref_y[:1000].abs().max()).item()
    del x64, ref_y
    host64 = torch.from_numpy(np.concatenate(parts)).cuda().double()
    model_h64 = PCA().setK(K).fit(host64)
    del host64
    out = {
        "phase": "main_path",
        "x": [int(xm.shape[0]), int(xm.shape[1]), str(xm.dtype)],
        "k": K,
        "launches": launches,
        "launches_device_fit": after_device_fit,
        "launches_host_fit": after_host_fit - after_device_fit,
        "fit_device_s_first": fit_device_s,
        "pc_finite": bool(np.isfinite(pc).all()),
        "pc_shape": list(pc.shape),
        "transform_shape": list(y.shape),
        "pc_vs_xla_max_abs": _pc_err(pc, model_xla.pc),
        "pc_vs_f64_max_abs": _pc_err(pc, model_64.pc),
        "ev_vs_xla_rel": _ev_rel(ev, model_xla.explainedVariance),
        "ev_vs_f64_rel": _ev_rel(ev, model_64.explainedVariance),
        "ev_top3": ev[:3].tolist(),
        "transform_rel": y_rel,
        "loaded_transform_rel": y_loaded_rel,
        "host_pc_vs_f64_max_abs": _pc_err(pc_h, model_h64.pc),
        "host_ev_vs_f64_rel": _ev_rel(model_h.explainedVariance, model_h64.explainedVariance),
    }
    emit(out)
    require(out["pc_finite"] and out["pc_shape"] == [D, K], "components not finite (d, k)")
    require(out["transform_shape"] == [N_MAIN, K], "transform shape")
    require(out["pc_vs_xla_max_abs"] <= 1e-3, "components differ from the xla route")
    require(out["pc_vs_f64_max_abs"] <= 1e-3, "components differ from the f64 fit")
    require(out["ev_vs_xla_rel"] <= 1e-4, "explained variance differs from the xla route")
    require(out["ev_vs_f64_rel"] <= 1e-4, "explained variance differs from the f64 fit")
    require(y_rel <= 1e-4 and y_loaded_rel <= 1e-4, "transform differs from x @ pc")
    require(out["host_pc_vs_f64_max_abs"] <= 1e-6, "host-partition components differ from the f64 fit")
    require(out["host_ev_vs_f64_rel"] <= 1e-10, "host-partition explained variance differs")
    return out, model


def phase_times(xm: torch.Tensor, model, peaks) -> dict:
    mean = xm.mean(dim=0)
    n, d = xm.shape
    kernel_ms = time_ms(lambda: k1.centered_gram_cuda(xm, mean))
    plain_ms = time_ms(lambda: k1.centered_gram_plain(xm, mean))

    def library():
        b = xm - mean
        return torch.matmul(b.T, b)

    library_ms = time_ms(library)
    bound_ms, bound_by = gram_bound_ms(n, d, xm.dtype, peaks)
    x64 = xm[:HOST_ROWS].double()
    mean64 = x64.mean(dim=0)
    f64_kernel_ms = time_ms(lambda: k1.centered_gram_cuda(x64, mean64))
    f64_plain_ms = time_ms(lambda: k1.centered_gram_plain(x64, mean64))

    def library64():
        b = x64 - mean64
        return torch.matmul(b.T, b)

    f64_library_ms = time_ms(library64)
    f64_bound_ms, f64_bound_by = gram_bound_ms(HOST_ROWS, d, torch.float64, peaks)
    del x64

    def fit(backend):
        m = PCA().setK(K).setCovarianceBackend(backend).fit(xm)
        return m.pc, m.explainedVariance

    out = {
        "phase": "times",
        "peaks": peaks[0],
        "k1_f32": {"shape": [n, d], "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "library_call": LIBRARY_GRAM,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "roofline_share": bound_ms / kernel_ms, "library_over_kernel": library_ms / kernel_ms},
        "k1_f64": {"shape": [HOST_ROWS, d], "kernel_ms": f64_kernel_ms, "plain_ms": f64_plain_ms,
                   "library_ms": f64_library_ms, "library_call": LIBRARY_GRAM + ", float64",
                   "bound_ms": f64_bound_ms, "bound_by": f64_bound_by,
                   "roofline_share": f64_bound_ms / f64_kernel_ms,
                   "library_over_kernel": f64_library_ms / f64_kernel_ms},
        "fit_wall_s": {"pallas": wall_s(lambda: fit("pallas")), "xla": wall_s(lambda: fit("xla"))},
        "transform_wall_s": wall_s(lambda: model.transform(xm)),
    }
    emit(out)
    return out


def phase_profile(xm: torch.Tensor) -> dict:
    """One ``pallas`` fit under ``torch.profiler``: device time by kernel
    and the device's busy share of the window (kernels run on one stream,
    so their device times do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fit = PCA().setK(K).setCovarianceBackend("pallas")
    fit.fit(xm)  # warm
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev = fit.fit(xm).explainedVariance  # reading it waits for the fit
        sync()
        window_ms = (time.perf_counter() - t0) * 1e3
    device_ms = {}
    for avg in prof.key_averages():
        # Device-side events only (kernels, copies, sets): a host op's
        # device time repeats that of the kernels it launched, and a
        # range's span on the device's timeline that of its kernels.
        if avg.device_type == DeviceType.CUDA and avg.self_device_time_total > 0 and not _is_annotation(avg):
            device_ms[avg.key] = device_ms.get(avg.key, 0.0) + avg.self_device_time_total / 1e3
    require(bool(np.isfinite(ev).all()), "profiled fit gave non-finite explained variance")
    busy_ms = sum(device_ms.values())
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]
    # Which solver produced the fit: eigh_auto again on the same covariance.
    cov = k1.centered_gram_cuda(xm, xm.mean(dim=0)) / (xm.shape[0] - 1)
    _, _, promoted = eigh_auto(cov, K, max_iters=auto_max_iters(fit.getEigenIters()))
    out = {
        "phase": "profile", "what": "PCA().setK(16).setCovarianceBackend('pallas').fit(x), 1M x 1024 f32",
        "window_ms": window_ms, "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / window_ms) if busy_ms else None,
        "eigh_auto_promoted": promoted,
        "top_device_ms": [{"kernel": k[:80], "ms": v} for k, v in top],
    }
    emit(out)
    return out


# --- KMeans: kernels K2 and K3 -------------------------------------------


def planted_blobs(n: int, d: int, k: int, gen: torch.Generator, scale: float = KM_SCALE):
    """n rows around k blob centers ~ N(0, scale^2) with unit noise, made
    on the card; blobs this far apart leave no row near a Voronoi boundary
    of centers near the blob means, so float32 labels are exact there."""
    dev = torch.device("cuda")
    truth = scale * torch.randn((k, d), generator=gen, device=dev)
    x = torch.empty((n, d), device=dev)
    x.normal_(generator=gen)
    x += truth[torch.randint(0, k, (n,), generator=gen, device=dev)]
    return x, truth


def near(truth: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Centers a little off the blob means (the state of a Lloyd pass)."""
    return (truth + 0.5 * torch.randn(truth.shape, generator=gen, device=truth.device)).contiguous()


def plain_blocked(x: torch.Tensor, c: torch.Tensor, mode: str):
    """The plain version in KM_BLOCK-row blocks (its (n, k) matrices fit),
    partials summed in float64; its own c2."""
    sums = torch.zeros(c.shape, dtype=torch.float64, device=x.device)
    counts = torch.zeros(c.shape[0], dtype=torch.int64, device=x.device)
    cost = 0.0
    for i in range(0, x.shape[0], KM_BLOCK):
        s, n, j, c2 = kk.assign_stats_plain(x[i:i + KM_BLOCK], c, mode)
        sums += s.double()
        counts += n
        cost += float(j)
    return sums, counts, cost, c2


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-300)).item()


def phase_kmeans_kernel_check(x100, c100, x16, c16, gen) -> dict:
    """K2 and K3 against their plain versions and an on-card float64
    computation of the same statistics (kmeans_stats_f64: the operands the
    mode multiplies, widened exactly, scored with the c2 the kernel
    returns), at the main path's shapes and two ragged ones, in every
    precision mode. Counts must be identical, sums and cost within 1e-5;
    K3 must equal K2 (counts, c2) within 1e-6; a repeat launch must be
    bitwise equal. The plain cost is held at the same bar after moving it
    onto the kernel's c2 (its own norms round differently, and that
    rounding is shared by every row of a cluster). The ragged shapes use
    blobs at scale 5: the cost is ``Σ‖x‖² + Σ(c2 − 2x·c)``, two float32
    terms per row far larger than the distance at scale 50, and a few
    thousand rows do not average their rounding out as 20M do."""
    cases = [("20M x 16, k=100", x100, c100), ("20M x 16, k=16", x16, c16)]
    for n, d, k in ((4099, 13, 7), (37, 5, 3)):
        xs, truth = planted_blobs(n, d, k, gen, scale=5.0)
        cases.append((f"{n} x {d}, k={k}", xs, near(truth, gen)))
    rows, main_err = [], {}
    for label, x, c in cases:
        kernels = [("assign_stats_fused", kk.assign_stats_fused)]
        if kk.packed_feasible(x.shape[1], c.shape[0]):
            kernels.append(("assign_stats_packed", kk.assign_stats_packed))
        for mode in KM_MODES:
            plain = plain_blocked(x, c, mode)
            got = {}
            for name, fn in kernels:
                out = fn(x, c, mode)
                again = fn(x, c, mode)
                sync()
                ref_sums, ref_counts, ref_cost, _ = kmeans_stats_f64(x, c, mode, c2=out[3], block_rows=KM_BLOCK)
                ref_cost = ref_cost.item()
                plain_cost = plain[2] + float((plain[1].double() * (out[3].double() - plain[3].double())).sum())
                row = {
                    "case": label, "kernel": name, "mode": mode,
                    "counts_equal_f64": bool(torch.equal(out[1], ref_counts)),
                    "counts_equal_plain": bool(torch.equal(out[1], plain[1])),
                    "sums_rel_f64": _rel(out[0], ref_sums),
                    "cost_rel_f64": abs(out[2].item() - ref_cost) / abs(ref_cost),
                    "plain_sums_rel_f64": _rel(plain[0], ref_sums),
                    "plain_cost_rel_f64": abs(plain_cost - ref_cost) / abs(ref_cost),
                    "vs_plain_max_abs": (out[0].double() - plain[0]).abs().max().item(),
                    "bitwise_repeat": all(torch.equal(u, v) for u, v in zip(out, again)),
                }
                rows.append(row)
                what = f"{name} {label} {mode}"
                require(row["counts_equal_f64"] and row["counts_equal_plain"], f"{what}: counts differ")
                require(row["sums_rel_f64"] <= 1e-5 and row["cost_rel_f64"] <= 1e-5, f"{what}: stats vs f64")
                require(row["plain_sums_rel_f64"] <= 1e-5 and row["plain_cost_rel_f64"] <= 1e-5,
                        f"plain {label} {mode}: stats vs f64")
                require(row["bitwise_repeat"], f"{what}: a repeat launch differs")
                if mode == "highest" and x.shape[0] == KM_N:
                    main_err.setdefault(name, row["vs_plain_max_abs"])
                got[name] = out
                del again
            if len(got) == 2:
                f, p = got["assign_stats_fused"], got["assign_stats_packed"]
                require(torch.equal(f[1], p[1]) and torch.equal(f[3], p[3]), f"K3 != K2 counts/c2 {label} {mode}")
                require(_rel(p[0], f[0]) <= 1e-6, f"K3 != K2 sums {label} {mode}")
                require(abs(p[2].item() - f[2].item()) <= 1e-6 * abs(f[2].item()), f"K3 != K2 cost {label} {mode}")
            del got, plain
    out = {"phase": "kmeans_kernel_check", "cases": rows, "main_max_abs_err": main_err}
    emit(out)
    return out


def _labels_f64(x64: torch.Tensor, centers64: torch.Tensor) -> torch.Tensor:
    return torch.cat([ops_kmeans.assign_clusters(x64[i:i + KM_BLOCK], centers64)[0]
                      for i in range(0, x64.shape[0], KM_BLOCK)])


def phase_kmeans_main_path(x: torch.Tensor) -> tuple:
    """KMeans through its public entry points, launch counters set to 0
    just before and read just after; then, outside the counted window, the
    same k = 100 fit from the fused fit's own initial centers on the
    ``xla`` route and in float64."""
    kk.reset_launches()
    t0 = time.perf_counter()
    model = KMeans().setK(KM_K).setSeed(SEED).fit(x)
    centers = model.clusterCenters()
    fit_first_s = time.perf_counter() - t0
    after_k100 = dict(kk.launches)
    model16 = KMeans().setK(KM_K_PACKED).setSeed(SEED).fit(x)
    centers16 = model16.clusterCenters()
    after_k16 = dict(kk.launches)
    labels = model.predict(x)
    labels_t = model.transform(x)
    sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "kmeans_model")
        model.write.overwrite().save(path)
        loaded = KMeansModel.load(path)
        loaded_labels = loaded.predict(x[:100_000])
    launches = dict(kk.launches)

    require(after_k100["assign_stats_fused"] >= 1 and after_k100["assign_stats_packed"] == 0,
            "the k=100 fit did not run on K2")
    require(after_k16["assign_stats_packed"] > after_k100["assign_stats_packed"], "the k=16 fit did not run on K3")
    require(np.array_equal(loaded.clusterCenters(), centers), "save/load changed the centers")
    require(loaded.getK() == KM_K and loaded.numIter == model.numIter, "save/load lost params or numIter")
    require(torch.equal(loaded_labels, labels[:100_000]), "the loaded model predicts differently")

    # References, outside the counted window.
    ones = torch.ones(x.shape[0], device=x.device)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(SEED)
    init = ops_kmeans.kmeans_plusplus_init(x, ones, gen, KM_K)
    again = KMeans().setK(KM_K).setInitialModel(init).fit(x)
    require(np.array_equal(again.clusterCenters(), centers), "the fit's own initial centers were not recovered")
    xla = KMeans().setK(KM_K).setInitialModel(init).setBackend("xla").fit(x)
    xla_centers = xla.clusterCenters()
    del ones
    x64 = x.double()
    c64, cost64, iter64 = ops_kmeans.lloyd(x64, torch.ones(x.shape[0], dtype=torch.float64, device=x.device),
                                           init.double(), block_rows=KM_BLOCK)
    labels64 = _labels_f64(x64, c64)
    del x64
    cost64 = cost64.item()
    c64 = c64.cpu().numpy()
    out = {
        "phase": "kmeans_main_path",
        "x": [int(x.shape[0]), int(x.shape[1]), str(x.dtype)],
        "k": [KM_K, KM_K_PACKED],
        "launches": launches,
        "launches_k100_fit": after_k100,
        "launches_k16_fit": {n: after_k16[n] - after_k100[n] for n in after_k16},
        "fit_first_s": fit_first_s,
        "num_iter": {"auto": model.numIter, "xla": xla.numIter, "f64": iter64, "k16": model16.numIter},
        "centers_finite": bool(np.isfinite(centers).all() and np.isfinite(centers16).all()),
        "centers_vs_xla_max_abs": float(np.abs(centers - xla_centers).max()),
        "centers_vs_f64_max_abs": float(np.abs(centers - c64).max()),
        "cost": model.trainingCost,
        "cost_vs_xla_rel": abs(model.trainingCost - xla.trainingCost) / abs(xla.trainingCost),
        "cost_vs_f64_rel": abs(model.trainingCost - cost64) / abs(cost64),
        "labels_vs_f64_mismatches": int((labels != labels64).sum()),
        "transform_equals_predict": bool(torch.equal(labels_t, labels)),
        "k16_cost": model16.trainingCost,
    }
    emit(out)
    require(out["centers_finite"], "centers not finite")
    require(list(centers.shape) == [KM_K, KM_D] and list(centers16.shape) == [KM_K_PACKED, KM_D], "center shapes")
    require(out["centers_vs_xla_max_abs"] <= 1e-3, "centers differ from the xla route")
    require(out["centers_vs_f64_max_abs"] <= 1e-3, "centers differ from the f64 fit")
    require(out["cost_vs_xla_rel"] <= 1e-4 and out["cost_vs_f64_rel"] <= 1e-4, "training cost differs")
    require(model.numIter == xla.numIter == iter64, "numIter differs between the routes")
    require(out["labels_vs_f64_mismatches"] == 0, "predict labels differ from the f64 model's")
    require(out["transform_equals_predict"], "transform differs from predict")
    require(labels.shape == (KM_N,), "predict shape")
    return out, model, model16


def assign_bound_ms(n: int, d: int, k: int, peaks) -> tuple:
    """Least time for one assignment + stats pass: x and the centers read
    once, sums, counts, cost and c2 written once, over HBM; 2·n·k·d
    operations (the score products, two per FMA) over the fp32 peak."""
    _, hbm, fp32, _ = peaks
    bytes_ms = (4 * (n * d + k * d) + 4 * k * d + 8 * k + 4 + 4 * k) / hbm * 1e3
    ops_ms = 2.0 * n * k * d / fp32 * 1e3
    return max(bytes_ms, ops_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def k2_sorted_by_label(x: torch.Tensor, c: torch.Tensor, bound_ms: float) -> dict:
    """K2 on the same rows ordered by their label (a table sorted by
    cluster: every warp's rows share one label but at a cluster's edge),
    held against float64 as phase_kmeans_kernel_check holds the shuffled
    rows, and timed as they are."""
    labels = kmeans_stats_f64(x, c, "highest", block_rows=KM_BLOCK)[3]
    xs = x[torch.argsort(labels, stable=True)]
    del labels
    out = kk.assign_stats_fused(xs, c, "highest")
    again = kk.assign_stats_fused(xs, c, "highest")
    ref_sums, ref_counts, ref_cost, _ = kmeans_stats_f64(xs, c, "highest", c2=out[3], block_rows=KM_BLOCK)
    ref_cost = ref_cost.item()
    row = {
        "counts_equal_f64": bool(torch.equal(out[1], ref_counts)),
        "sums_rel_f64": _rel(out[0], ref_sums),
        "cost_rel_f64": abs(out[2].item() - ref_cost) / abs(ref_cost),
        "bitwise_repeat": all(torch.equal(u, v) for u, v in zip(out, again)),
        "kernel_ms": time_ms(lambda: kk.assign_stats_fused(xs, c, "highest")),
        "device_ms": graph_ms(lambda: kk.assign_stats_fused(xs, c, "highest"), calls=10),
    }
    row["device_roofline_share"] = bound_ms / row["device_ms"]
    del xs, out, again
    require(row["counts_equal_f64"], "K2 on label-sorted rows: counts differ from float64")
    require(row["sums_rel_f64"] <= 1e-5 and row["cost_rel_f64"] <= 1e-5, "K2 on label-sorted rows: stats vs f64")
    require(row["bitwise_repeat"], "K2 on label-sorted rows: a repeat launch differs")
    return row


def phase_kmeans_times(x, model, model16, peaks) -> dict:
    """K2 at 20M x 16, k = 100 and K3 at k = 16 (the main path's shapes,
    the fitted centers, ``highest``), each beside its plain version on the
    same inputs and its bound, and K2 again on the rows sorted by label;
    fit and predict wall times. ``kernel_ms`` is one eager call between
    CUDA events, so it holds the wrapper's host path up to the launch;
    ``device_ms`` is the card's time a call, from 10 calls replayed in a
    CUDA graph."""
    reason = ("no single PyTorch call computes the assignment (argmin of the "
              "distances) together with the per-cluster sums, counts and cost")
    print(f"kmeans library_ms: null, {reason}", flush=True)
    rows = {}
    for name, fn, m in (("assign_stats_fused", kk.assign_stats_fused, model),
                        ("assign_stats_packed", kk.assign_stats_packed, model16)):
        c = torch.tensor(m.clusterCenters(), dtype=torch.float32, device=x.device)
        n, d = x.shape
        k = c.shape[0]
        bound_ms, bound_by = assign_bound_ms(n, d, k, peaks)
        kernel_ms = time_ms(lambda: fn(x, c, "highest"))
        device_ms = graph_ms(lambda: fn(x, c, "highest"), calls=10)
        plain_ms = time_ms(lambda: kk.assign_stats_plain(x, c, "highest"), repeats=3, warmup=1)
        rows[name] = {"shape": [n, d], "k": k, "kernel_ms": kernel_ms, "device_ms": device_ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": None, "library_why_none": reason,
                      "roofline_share": bound_ms / kernel_ms,
                      "device_roofline_share": bound_ms / device_ms}
        if name == "assign_stats_fused":
            rows[name]["sorted_by_label"] = k2_sorted_by_label(x, c, bound_ms)
        torch.cuda.empty_cache()

    def fit(backend, k=KM_K):
        return KMeans().setK(k).setSeed(SEED).setBackend(backend).fit(x).trainingCost

    out = {
        "phase": "kmeans_times", "peaks": peaks[0], **rows,
        "fit_wall_s": {"auto": wall_s(lambda: fit("auto")), "xla": wall_s(lambda: fit("xla")),
                       "auto_k16": wall_s(lambda: fit("auto", KM_K_PACKED))},
        "predict_wall_s": wall_s(lambda: model.predict(x)),
    }
    emit(out)
    return out


def _is_annotation(evt) -> bool:
    """A range's span on the device's timeline (every ``TraceRange`` is a
    ``record_function`` while a profiler runs), not a kernel."""
    flag = getattr(evt, "is_user_annotation", False)
    return bool(flag() if callable(flag) else flag)


def _device_ms_by_kernel(prof) -> dict:
    from torch.autograd import DeviceType

    device_ms = {}
    for avg in prof.key_averages():
        if avg.device_type == DeviceType.CUDA and avg.self_device_time_total > 0 and not _is_annotation(avg):
            device_ms[avg.key] = device_ms.get(avg.key, 0.0) + avg.self_device_time_total / 1e3
    return device_ms


def phase_kmeans_profile(x: torch.Tensor) -> dict:
    """One k = 100 fit (auto: K2) under ``torch.profiler``: device time by
    kernel and the device's idle share. The Python Lloyd loop reads the
    movement once per iteration, one host sync each."""
    from torch.profiler import ProfilerActivity, profile

    est = KMeans().setK(KM_K).setSeed(SEED)
    est.fit(x)  # warm
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = est.fit(x)
        cost = model.trainingCost  # reading it waits for the fit
        sync()
        window_ms = (time.perf_counter() - t0) * 1e3
    require(np.isfinite(cost), "profiled fit gave a non-finite cost")
    device_ms = _device_ms_by_kernel(prof)
    busy_ms = sum(device_ms.values())
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:10]
    out = {
        "phase": "kmeans_profile", "what": "KMeans().setK(100).setSeed(0).fit(x), 20M x 16 f32, backend auto",
        "num_iter": model.numIter, "window_ms": window_ms, "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / window_ms) if busy_ms else None,
        "top_device_ms": [{"kernel": k[:80], "ms": v} for k, v in top],
    }
    emit(out)
    return out


def kmeans_phases(gen: torch.Generator, peaks) -> dict:
    x100, truth100 = planted_blobs(KM_N, KM_D, KM_K, gen)
    x16, truth16 = planted_blobs(KM_N, KM_D, KM_K_PACKED, gen)
    check = phase_kmeans_kernel_check(x100, near(truth100, gen), x16, near(truth16, gen), gen)
    del x16
    torch.cuda.empty_cache()
    main_path, model, model16 = phase_kmeans_main_path(x100)
    torch.cuda.empty_cache()
    times = phase_kmeans_times(x100, model, model16, peaks)
    phase_kmeans_profile(x100)
    return {"check": check, "main_path": main_path, "times": times}


# --- UMAP: kernel K4 -------------------------------------------------------


def umap_blobs(n: int, truth: torch.Tensor, gen: torch.Generator):
    """n rows around the blob centers ``truth`` with unit noise, and their
    blob labels, made on the card."""
    labels = torch.randint(0, truth.shape[0], (n,), generator=gen, device=truth.device)
    x = torch.randn((n, truth.shape[1]), generator=gen, device=truth.device)
    x += truth[labels]
    return x, labels


def umap_estimator() -> UMAP:
    """Config 13's estimator (benchmarks/config13_umap.py)."""
    return (UMAP().setNNeighbors(UM_K).setNComponents(UM_DIM).setNEpochs(UM_EPOCHS)
            .setBuildAlgo("brute_approx").setInit("random").setSeed(SEED))


def umap_graph(x: torch.Tensor):
    """The fit's graph stage through the ops: kNN without self, the fuzzy
    set, and K4's tail plan."""
    dists, idx = _knn_excluding_self(x, UM_K, "euclidean", approx=True)
    graph = ops_umap.fuzzy_simplicial_set(idx, dists)
    return dists, graph, k4.build_tail_plan(graph.indices, x.shape[0], UM_DIM)


def phase_umap_kernel_check(x: torch.Tensor, gen: torch.Generator) -> dict:
    """The kNN graph against an on-card float64 exact kNN (UM_KNN_Q query
    rows), and K4 against its plain version and a float64 ``index_add_``
    at config 13's edge stream (the graph's own tails)."""
    dists, graph, plan = umap_graph(x)
    q = x[:UM_KNN_Q].double()
    d64 = torch.cdist(q, x.double())
    d64[torch.arange(UM_KNN_Q, device=x.device), torch.arange(UM_KNN_Q, device=x.device)] = float("inf")
    ref_d, ref_i = torch.topk(d64, UM_K, dim=1, largest=False)
    del d64
    got_i = graph.indices[:UM_KNN_Q].long()
    hits = (got_i[:, :, None] == ref_i[:, None, :]).any(dim=2).sum().item()
    recall = hits / (UM_KNN_Q * UM_K)
    dist_rel = ((dists[:UM_KNN_Q].double() - ref_d).abs() / ref_d.clamp_min(1e-30)).max().item()

    n = x.shape[0]
    e = n * UM_K
    indeg = torch.bincount(graph.indices.reshape(-1).long(), minlength=n)
    g = torch.randn((e, UM_DIM), generator=gen, device=x.device)
    out = k4.tail_accumulate(g, plan)
    again = k4.tail_accumulate(g, plan)
    plain = k4.tail_accumulate_plain(g, plan)
    ref = torch.zeros((n, UM_DIM), dtype=torch.float64, device=x.device)
    ref.index_add_(0, graph.indices.reshape(-1).long(), g.double())
    scale = ref.abs().max().item()
    out_d = {
        "phase": "umap_kernel_check",
        "knn_queries": UM_KNN_Q, "knn_recall_vs_f64": recall, "knn_dist_rel_vs_f64": dist_rel,
        "edges": e, "in_degree_max": int(indeg.max()), "in_degree_p99": float(torch.quantile(indeg.double(), 0.99)),
        "rows_without_in_edges": int((indeg == 0).sum()),
        "k4_rel_vs_f64": (out.double() - ref).abs().max().item() / scale,
        "plain_rel_vs_f64": (plain.double() - ref).abs().max().item() / scale,
        "k4_vs_plain_max_abs": (out - plain).abs().max().item(),
        "k4_bitwise_repeat": bool(torch.equal(out, again)),
        "perm_is_stable_argsort": bool(torch.equal(
            plan.perm.long(), torch.argsort(graph.indices.reshape(-1).long(), stable=True))),
    }
    emit(out_d)
    require(recall >= 0.999, f"kNN recall {recall:.5f} < 0.999 against the float64 kNN")
    require(dist_rel <= 1e-4, f"kNN distances {dist_rel:.3e} from float64, > 1e-4 relative")
    require(out_d["k4_rel_vs_f64"] <= 1e-6, "K4 differs from the float64 index_add_")
    require(out_d["plain_rel_vs_f64"] <= 1e-5, "the plain version differs from the float64 index_add_")
    require(out_d["k4_bitwise_repeat"], "a repeat K4 launch differs")
    require(out_d["perm_is_stable_argsort"], "the plan's perm is not the stable argsort of the tails")
    return out_d, graph, plan, g


def _umap_trust(x, emb, sub) -> float:
    return trustworthiness(x[sub], emb[sub].to(x.device), 10)


def _blob_hits(emb_train, labels, emb_new, labels_new) -> float:
    """Share of new rows whose embedding lies nearest their own blob's
    centroid in the training layout (tests/test_umap.py's transform bar)."""
    cents = torch.stack([emb_train[labels == c].mean(dim=0) for c in range(UM_BLOBS)])
    nearest = torch.cdist(emb_new.float(), cents).argmin(dim=1)
    return (nearest == labels_new).float().mean().item()


def phase_umap_main_path(x, labels, x_new, labels_new, graph, plan, gen) -> tuple:
    """UMAP through its public entry points, the launch counters set to 0
    just before and read just after; then, outside the counted window,
    one epoch on K4 against the plain route from the same layout and
    negatives, a whole fit on the plain route, and the structural bars."""
    k4.reset_launches()
    t0 = time.perf_counter()
    model = umap_estimator().fit(x)
    emb = model._emb_raw
    sync()
    fit_first_s = time.perf_counter() - t0
    after_fit = k4.launches["tail_accumulate"]
    emb_new = model.transform(x_new)
    sync()
    after_transform = k4.launches["tail_accumulate"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "umap_model")
        model.write.overwrite().save(path)
        loaded = UMAPModel.load(path)
        loaded_new = loaded.transform(x_new[:1000])
    launches = {"tail_accumulate": k4.launches["tail_accumulate"]}
    # The same 1,000 rows through the fitted model: the transform SGD
    # amplifies ulps, and cuBLAS may round a 1,000-row product otherwise
    # than a 10,000-row one, so the comparison keeps the batch.
    fitted_new = model.transform(x_new[:1000])

    require(after_fit == UM_EPOCHS, f"the fit launched K4 {after_fit} times, not once per epoch ({UM_EPOCHS})")
    require(after_transform == after_fit, "transform launched K4")
    require(np.array_equal(loaded.embedding, model.embedding), "save/load changed the embedding")
    require(loaded.getNNeighbors() == UM_K and (loaded.a, loaded.b) == (model.a, model.b), "save/load lost params")

    # Outside the counted window: one epoch, K4 against the plain route.
    a, b = model.a, model.b
    y0 = (10.0 * (2.0 * torch.rand((UM_N, UM_DIM), generator=gen, device=x.device) - 1.0)).contiguous()
    kw = dict(n_epochs=UM_EPOCHS, neg_rate=5, neg_pool=256, learning_rate=1.0, repulsion=1.0,
              a=a, b=b, move_other=True)
    neg = torch.randint(0, UM_N, (256,), generator=gen, device=x.device)
    one_k4 = ops_umap._make_epoch_fn((UM_N, UM_DIM), graph, None, tail_plan=plan, **kw)(0, y0, neg)
    one_plain = ops_umap._make_epoch_fn((UM_N, UM_DIM), graph, None, **kw)(0, y0, neg)
    # The plain route sums each tail row in float32 atomics in no fixed
    # order, K4 in float64: a hub row of several hundred in-edges differs
    # by ~1e-5 (some sqrt(in-degree) float32 roundings of its terms). The
    # bar is 1e-5 of the layout's scale, max(1, max |y|).
    epoch_err = (one_k4 - one_plain).abs().max().item()
    epoch_scale = max(1.0, one_plain.abs().max().item())
    # A whole fit on the plain route, from the same kind of random layout.
    fit_gen = torch.Generator(device=x.device)
    fit_gen.manual_seed(SEED + 1)
    y_start = 10.0 * (2.0 * torch.rand((UM_N, UM_DIM), generator=fit_gen, device=x.device) - 1.0)
    plain_emb = ops_umap.optimize_layout(y_start, graph, fit_gen, a=a, b=b, n_epochs=UM_EPOCHS)
    sub = torch.randperm(UM_N, generator=gen, device=x.device)[:UM_SUB]
    trust = _umap_trust(x, emb, sub)
    trust_plain = _umap_trust(x, plain_emb, sub)
    out = {
        "phase": "umap_main_path",
        "x": [int(x.shape[0]), int(x.shape[1]), str(x.dtype)], "k": UM_K, "epochs": UM_EPOCHS,
        "launches": launches, "launches_fit": after_fit, "launches_transform": after_transform - after_fit,
        "fit_first_s": fit_first_s,
        "embedding_shape": list(emb.shape), "embedding_finite": bool(torch.isfinite(emb).all()),
        "one_epoch_k4_vs_plain_max_abs": epoch_err, "one_epoch_max_abs_y": epoch_scale,
        "trustworthiness": trust, "trustworthiness_plain_route": trust_plain,
        "transform_shape": list(emb_new.shape),
        "transform_blob_hits": _blob_hits(emb, labels, emb_new, labels_new),
        "loaded_transform_max_abs": (loaded_new - fitted_new).abs().max().item(),
    }
    emit(out)
    require(out["embedding_finite"] and out["embedding_shape"] == [UM_N, UM_DIM], "embedding not finite (n, 2)")
    require(epoch_err <= 1e-5 * epoch_scale,
            f"one epoch on K4 differs from the plain route by {epoch_err:.3e} at |y| <= {epoch_scale:.1f}")
    require(trust > 0.85, f"trustworthiness {trust:.4f} <= 0.85")
    require(abs(trust - trust_plain) <= 0.03, f"trustworthiness {trust:.4f} vs plain route {trust_plain:.4f}")
    require(out["transform_shape"] == [UM_NEW, UM_DIM], "transform shape")
    require(out["transform_blob_hits"] >= 0.9, "fewer than 90% of new rows land nearest their blob")
    require(out["loaded_transform_max_abs"] <= 1e-5, "the loaded model transforms differently")
    return out, model


def tail_bound_ms(n: int, e: int, dim: int, peaks) -> tuple:
    """Least time for K4: g (e, dim) f32, perm (e) and offsets (n + 1)
    int32 read once, out (n, dim) f32 written once, over HBM; e·dim adds
    over the fp32 peak."""
    _, hbm, fp32, _ = peaks
    bytes_ms = (4 * e * dim + 4 * e + 4 * (n + 1) + 4 * n * dim) / hbm * 1e3
    ops_ms = e * dim / fp32 * 1e3
    return max(bytes_ms, ops_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def phase_umap_times(x, x_new, model, graph, plan, g, peaks) -> dict:
    """K4 at config 13's edge stream beside its plain version, the library
    call (one ``index_add_`` of the unsorted stream) and its bound; the
    fit's graph and SGD phases, the whole fit and transform."""
    n, e = UM_N, UM_N * UM_K
    tails = graph.indices.reshape(-1).long()
    calls = {
        "kernel": lambda: k4.tail_accumulate(g, plan),
        "plain": lambda: k4.tail_accumulate_plain(g, plan),
        "library": lambda: torch.zeros((n, UM_DIM), device=x.device).index_add_(0, tails, g),
    }
    # Device time (graph replay) is the comparison; the eager time of one
    # call, events around it, is the host's Python and launch path.
    device_ms = {name: graph_ms(fn) for name, fn in calls.items()}
    eager_ms = {name: time_ms(fn, repeats=50) for name, fn in calls.items()}
    kernel_ms, plain_ms, library_ms = device_ms["kernel"], device_ms["plain"], device_ms["library"]
    bound_ms, bound_by = tail_bound_ms(n, e, UM_DIM, peaks)

    emb0 = 10.0 * (2.0 * torch.rand((n, UM_DIM), device=x.device) - 1.0)

    def sgd():
        gen = torch.Generator(device=x.device)
        gen.manual_seed(SEED)
        ops_umap.optimize_layout(emb0, graph, gen, a=model.a, b=model.b, n_epochs=UM_EPOCHS, tail_plan=plan)

    out = {
        "phase": "umap_times", "peaks": peaks[0],
        "tail_accumulate": {"edges": e, "n": n, "dim": UM_DIM, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                            "library_ms": library_ms, "library_call": "zeros(n, 2).index_add_(0, tails, g)",
                            "bound_ms": bound_ms, "bound_by": bound_by, "roofline_share": bound_ms / kernel_ms,
                            "library_over_kernel": library_ms / kernel_ms,
                            "timing": "device time per call, 50 calls in one CUDA graph, median of 5 replays",
                            "eager_call_ms": eager_ms},
        "fit_wall_s": wall_s(lambda: umap_estimator().fit(x)._emb_raw),
        "graph_phase_wall_s": wall_s(lambda: umap_graph(x)),
        "sgd_phase_wall_s": wall_s(sgd),
        "transform_wall_s": wall_s(lambda: model.transform(x_new)),
    }
    emit(out)
    return out


def phase_umap_profile(x: torch.Tensor) -> dict:
    """One config-13 fit under ``torch.profiler``: device time by kernel
    and the device's idle share. The epoch loop launches ~35 small kernels
    an epoch and never syncs."""
    from torch.profiler import ProfilerActivity, profile

    est = umap_estimator()
    est.fit(x)  # warm
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        emb = est.fit(x)._emb_raw
        sync()
        window_ms = (time.perf_counter() - t0) * 1e3
    require(bool(torch.isfinite(emb).all()), "profiled fit gave a non-finite embedding")
    device_ms = _device_ms_by_kernel(prof)
    busy_ms = sum(device_ms.values())
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:12]
    out = {
        "phase": "umap_profile", "what": "config 13 UMAP fit, 50,000 x 64 f32, 200 epochs, K4 tail route",
        "window_ms": window_ms, "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / window_ms) if busy_ms else None,
        "kernels_launched": sum(avg.count for avg in prof.key_averages()
                                if avg.device_type.name == "CUDA" and avg.self_device_time_total > 0
                                and not _is_annotation(avg)),
        "top_device_ms": [{"kernel": k[:80], "ms": v} for k, v in top],
    }
    emit(out)
    return out


def phase_umap_spectral(x: torch.Tensor, labels: torch.Tensor, gen: torch.Generator) -> dict:
    """A fit at the spectral-init cap (8,192 rows: one dense Laplacian
    eigh on the card), held to the trustworthiness bar."""
    xs = x[:UM_SPECTRAL_N]
    k4.reset_launches()
    t0 = time.perf_counter()
    model = UMAP().setNNeighbors(UM_K).setNEpochs(UM_EPOCHS).setSeed(SEED).fit(xs)
    emb = model._emb_raw
    sync()
    wall = time.perf_counter() - t0
    sub = torch.randperm(UM_SPECTRAL_N, generator=gen, device=x.device)[:UM_SUB]
    out = {
        "phase": "umap_spectral", "x": [UM_SPECTRAL_N, UM_D], "init": model.getInit(), "epochs": UM_EPOCHS,
        "fit_first_s": wall, "launches": k4.launches["tail_accumulate"],
        "embedding_finite": bool(torch.isfinite(emb).all()),
        "trustworthiness": _umap_trust(xs, emb, sub),
    }
    emit(out)
    require(out["embedding_finite"], "the spectral-init fit is not finite")
    require(out["launches"] == UM_EPOCHS, "the spectral-init fit did not run K4 every epoch")
    require(out["trustworthiness"] > 0.85, "the spectral-init fit's trustworthiness <= 0.85")
    return out


def umap_phases(gen: torch.Generator, peaks) -> dict:
    truth = UM_SCALE * torch.randn((UM_BLOBS, UM_D), generator=gen, device="cuda")
    x, labels = umap_blobs(UM_N, truth, gen)
    x_new, labels_new = umap_blobs(UM_NEW, truth, gen)
    check, graph, plan, g = phase_umap_kernel_check(x, gen)
    main_path, model = phase_umap_main_path(x, labels, x_new, labels_new, graph, plan, gen)
    times = phase_umap_times(x, x_new, model, graph, plan, g, peaks)
    phase_umap_profile(x)
    phase_umap_spectral(x, labels, gen)
    return {"check": check, "main_path": main_path, "times": times}


# --- Wide and streaming fits (no kernel of their own) -----------------------


def _pc_err_aligned(a: np.ndarray, b: np.ndarray) -> float:
    """Max |a − b| after each column of ``a`` takes the sign that agrees
    with ``b``'s."""
    signs = np.where(np.sum(a * b, axis=0) < 0, -1.0, 1.0)
    return float(np.abs(a * signs - b).max())


def _ev_rel_each(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a - b) / np.abs(b)))


def wide_oracle(x: torch.Tensor, k: int) -> dict:
    """The exact float64 answer for the wide rows: the Gram around the
    float32 column mean (K1's input) in row chunks, the covariance
    corrected to the float64 mean, and its top-k eigenpairs (one dense
    float64 ``eigh``)."""
    n, d = x.shape
    mean32 = x.mean(dim=0)
    m = mean32.double()
    mean64 = torch.zeros(d, dtype=torch.float64, device=x.device)
    gram = torch.zeros((d, d), dtype=torch.float64, device=x.device)
    for i in range(0, n, ORACLE_CHUNK):
        b = x[i:i + ORACLE_CHUNK].double()
        mean64 += b.sum(dim=0)
        b -= m
        gram.addmm_(b.T, b)
        del b
    mean64 /= n
    delta = mean64 - m
    # Σ(x − μ)(x − μ)ᵀ = Σ(x − m)(x − m)ᵀ − n·(μ − m)(μ − m)ᵀ
    cov = (gram - n * torch.outer(delta, delta)) / (n - 1)
    w, v = torch.linalg.eigh(cov)
    w = torch.flip(w, (0,))
    return {"mean32": mean32, "gram": gram, "cov": cov, "w": w[:k].cpu().numpy(),
            "v": sign_flip(torch.flip(v, (1,))[:, :k]).cpu().numpy(),
            "total": float(torch.trace(cov))}


def _against_oracle(pc: np.ndarray, ev: np.ndarray, oracle: dict) -> dict:
    v = torch.from_numpy(pc).to(device=oracle["cov"].device, dtype=torch.float64)
    captured = float(torch.trace(v.T @ oracle["cov"] @ v))
    exact_ratio = oracle["w"] / oracle["total"]
    return {
        "captured_variance_share": captured / float(oracle["w"].sum()),
        "top4_pc_max_abs": _pc_err_aligned(pc[:, :4], oracle["v"][:, :4]),
        "top4_ev_rel": _ev_rel_each(ev[:4], exact_ratio[:4]),
    }


def _require_oracle(what: str, got: dict) -> None:
    require(got["captured_variance_share"] >= 0.99,
            f"{what}: captured variance {got['captured_variance_share']:.5f} < 0.99 of the exact top-{K}")
    require(got["top4_pc_max_abs"] <= 1e-2, f"{what}: top-4 components {got['top4_pc_max_abs']:.3e} > 1e-2")
    require(got["top4_ev_rel"] <= 1e-3, f"{what}: top-4 ratios {got['top4_ev_rel']:.3e} > 1e-3 relative")


def phase_wide_pca(x: torch.Tensor) -> tuple:
    """The default fit at d = 8,192 (twice the sketch threshold) on a card
    tensor: it must take the randomized sketch, shown by the sketch's own
    counter; held against the same algorithm in float64 with the same Ω,
    and against the exact float64 eigenpairs; timed beside the covariance
    path under ``xla`` and ``pallas`` (K1 at d = 8,192, its Gram held to
    the float64 Gram at or below the library call's error)."""
    t_phase = time.perf_counter()
    n, d = x.shape
    sketches = counter_value("pca.sketch")
    t0 = time.perf_counter()
    model = PCA().setK(K).fit(x)
    pc, ev = model.pc, model.explainedVariance
    fit_first_s = time.perf_counter() - t0
    took_sketch = counter_value("pca.sketch") - sketches
    require(took_sketch == 1, f"the default fit at d = {d} did not take the randomized sketch")

    # The same algorithm in float64 from the fit's own draw.
    omega = draw_omega(d, min(K + 10, d, n), x.dtype).double()
    x64 = x.double()
    c64, r64, _ = randomized_pca(x64, K, omega)
    del x64
    same_pc = _pc_err_aligned(pc, c64.cpu().numpy())
    same_ev = _ev_rel_each(ev, r64.cpu().numpy())
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    oracle = wide_oracle(x, K)
    oracle_s = time.perf_counter() - t0
    vs_oracle = _against_oracle(pc, ev, oracle)

    # K1 at d = 8,192 against the float64 Gram, beside the library call.
    mean32 = oracle["mean32"]
    scale = oracle["gram"].abs().max().item()
    got = k1.centered_gram_cuda(x, mean32)
    k1_err = (got.double() - oracle["gram"]).abs().max().item() / scale
    del got
    b = x - mean32
    lib = torch.matmul(b.T, b)
    del b
    lib_err = (lib.double() - oracle["gram"]).abs().max().item() / scale
    del lib
    torch.cuda.empty_cache()

    def fit(solver, backend="xla"):
        m = PCA().setK(K).setSolver(solver).setCovarianceBackend(backend).fit(x)
        return m.pc, m.explainedVariance

    # One launch per row slice that the workspace cap allows.
    want_launches = -(-n // k1.launch_rows(n, d, x.dtype))
    k1.reset_launches()
    cov_pc, cov_ev = fit("covariance", "pallas")
    pallas_launches = k1.launches
    times = {
        "randomized": wall_s(lambda: fit("auto")),
        "covariance_xla": wall_s(lambda: fit("covariance"), repeats=1),
        "covariance_pallas": wall_s(lambda: fit("covariance", "pallas"), repeats=1),
    }
    out = {
        "phase": "wide_pca", "x": [n, d, str(x.dtype)], "k": K,
        "route": "randomized sketch (counter pca.sketch +1)", "sketch_counter_delta": took_sketch,
        "fit_first_s": fit_first_s,
        "pc_vs_same_omega_f64_max_abs": same_pc, "ev_vs_same_omega_f64_rel": same_ev,
        "oracle": vs_oracle, "oracle_s": oracle_s,
        "covariance_pallas_vs_oracle": _against_oracle(cov_pc, cov_ev, oracle),
        "k1_d8192": {"launches_in_pallas_fit": pallas_launches, "launches_planned": want_launches,
                     "rel_err_vs_f64": k1_err,
                     "library_rel_err_vs_f64": lib_err, "library_call": LIBRARY_GRAM},
        "fit_wall_s": times,
        "timing": "randomized: median of 3; covariance fits: one fit each",
        "ev_top3": ev[:3].tolist(),
    }
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    require(bool(np.isfinite(pc).all()) and list(pc.shape) == [d, K], "wide components not finite (d, k)")
    require(same_pc <= 1e-3, f"wide sketch vs the float64 sketch: components {same_pc:.3e} > 1e-3")
    require(same_ev <= 1e-4, f"wide sketch vs the float64 sketch: ratios {same_ev:.3e} > 1e-4 relative")
    _require_oracle("wide sketch", vs_oracle)
    require(pallas_launches == want_launches,
            f"the pallas covariance fit at d = {d} launched K1 {pallas_launches} times, "
            f"its row slices call for {want_launches}")
    require(k1_err <= lib_err, f"K1 at d = 8192: error {k1_err:.3e} above the library call's {lib_err:.3e}")
    return out, oracle, ev


def phase_streaming_wide_pca(blocks: list, oracle: dict, sketch_ev: np.ndarray) -> dict:
    """The wide rows as host blocks through an iterator factory: ``solver``
    auto peeks one block's width and runs the streaming sketch (a moments
    pass and three passes over the blocks)."""
    t_phase = time.perf_counter()
    streams = counter_value("pca.sketch.stream")
    passes = counter_value("pca.sketch.stream.passes")
    opened = []  # host clock at each fresh iterator: the width probe, then one per pass

    def factory():
        opened.append(time.perf_counter())
        return iter(blocks)

    t0 = time.perf_counter()
    model = PCA().setK(K).fit(factory)
    pc, ev = model.pc, model.explainedVariance
    wall = time.perf_counter() - t0
    n_passes = counter_value("pca.sketch.stream.passes") - passes
    ends = opened[2:] + [t0 + wall]
    vs_oracle = _against_oracle(pc, ev, oracle)
    out = {
        "phase": "streaming_wide_pca",
        "x": [sum(b.shape[0] for b in blocks), int(blocks[0].shape[1]), str(blocks[0].dtype)],
        "blocks": len(blocks), "block_rows": int(blocks[0].shape[0]), "k": K,
        "route": "streaming randomized sketch (counter pca.sketch.stream +1)",
        "fit_wall_s": wall, "passes": n_passes,
        "pass_s": {"moments (host float64)": ends[0] - opened[1],
                   "power and Rayleigh-Ritz (card)": [e - s for s, e in zip(opened[2:], ends[1:])]},
        "oracle": vs_oracle,
        # The streaming sketch's subspace is (XᵀX)²Ω, the in-memory one's
        # (XᵀX)³Ω (the reference's two algorithms at power_iters = 2), so
        # their trailing ratios differ by more than their leading ones.
        "top4_ev_vs_in_memory_sketch_rel": _ev_rel_each(ev[:4], sketch_ev[:4]),
        "ev_vs_in_memory_sketch_rel": _ev_rel_each(ev, sketch_ev),
    }
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    require(counter_value("pca.sketch.stream") - streams == 1, "the wide stream did not take the streaming sketch")
    require(n_passes == 4, f"the streaming sketch made {n_passes} passes, not 4")
    _require_oracle("streaming wide sketch", vs_oracle)
    require(out["top4_ev_vs_in_memory_sketch_rel"] <= 1e-3,
            "streaming sketch top-4 ratios differ from the in-memory sketch's by > 1e-3 relative")
    return out


def _h2d_ms(prof) -> float:
    return sum(ms for key, ms in _device_ms_by_kernel(prof).items() if "HtoD" in key)


def phase_streaming_pca(x: torch.Tensor, blocks: list) -> dict:
    """PCA over host blocks at constant memory: a one-shot generator and an
    iterator factory (d = 1,024 < 4,096: the one-pass streaming
    covariance), the streaming transform, one factory fit under
    ``torch.profiler`` (the device's idle share and its host-to-device
    copy time); held against an on-card float64 fit of the same rows."""
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    n = sum(b.shape[0] for b in blocks)
    nbytes = sum(b.nbytes for b in blocks)
    sketches = counter_value("pca.sketch") + counter_value("pca.sketch.stream")
    t0 = time.perf_counter()
    model_gen = PCA().setK(K).fit(iter(blocks))
    pc_gen = model_gen.pc
    gen_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = PCA().setK(K).fit(lambda: iter(blocks))
    pc, ev = model.pc, model.explainedVariance
    factory_wall = time.perf_counter() - t0
    took_sketch = counter_value("pca.sketch") + counter_value("pca.sketch.stream") - sketches

    t0 = time.perf_counter()
    y = np.concatenate(list(model.transform(lambda: iter(blocks))))
    transform_wall = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        PCA().setK(K).fit(lambda: iter(blocks)).explainedVariance
        sync()
        window_ms = (time.perf_counter() - t0) * 1e3
    device_ms = _device_ms_by_kernel(prof)
    busy_ms = sum(device_ms.values())
    h2d_ms = _h2d_ms(prof)

    # The reference: an on-card float64 fit of the same rows.
    model64 = PCA().setK(K).fit(x.double())
    pc64, ev64 = model64.pc, model64.explainedVariance
    torch.cuda.empty_cache()
    pc_dev = torch.from_numpy(pc).to(x.device)
    y_ref = torch.cat([x[i:i + HOST_ROWS].double() @ pc_dev for i in range(0, n, HOST_ROWS)]).cpu().numpy()
    y_rel = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
    out = {
        "phase": "streaming_pca", "x": [n, int(blocks[0].shape[1]), str(blocks[0].dtype)],
        "blocks": len(blocks), "block_rows": int(blocks[0].shape[0]), "k": K,
        "route": "one-pass streaming covariance, float64 on the card", "sketch_counter_delta": took_sketch,
        "fit_wall_s": {"generator": gen_wall, "factory": factory_wall},
        "rows_per_s": {"generator": n / gen_wall, "factory": n / factory_wall},
        "host_bytes": nbytes, "h2d_bytes_per_s_over_fit_wall": nbytes / factory_wall,
        "transform_wall_s": transform_wall,
        "profile": {"window_ms": window_ms, "device_busy_ms": busy_ms,
                    "device_idle_share": (1.0 - busy_ms / window_ms) if busy_ms else None,
                    "h2d_copy_ms": h2d_ms, "h2d_share_of_window": h2d_ms / window_ms,
                    "h2d_bytes_per_s_while_copying": nbytes / (h2d_ms / 1e3) if h2d_ms else None,
                    "top_device_ms": [{"kernel": k[:80], "ms": v}
                                      for k, v in sorted(device_ms.items(), key=lambda kv: -kv[1])[:6]]},
        "pc_vs_f64_max_abs": {"generator": _pc_err(pc_gen, pc64), "factory": _pc_err(pc, pc64)},
        "ev_vs_f64_rel": {"generator": _ev_rel(model_gen.explainedVariance, ev64), "factory": _ev_rel(ev, ev64)},
        "transform_rel": y_rel,
    }
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    require(took_sketch == 0, "a d = 1024 stream took the sketch")
    require(y.shape == (n, K), "streaming transform shape")
    for kind in ("generator", "factory"):
        require(out["pc_vs_f64_max_abs"][kind] <= 1e-6, f"streaming {kind} components differ from the f64 fit")
        require(out["ev_vs_f64_rel"][kind] <= 1e-10, f"streaming {kind} explained variance differs from the f64 fit")
    require(y_rel <= 1e-4, "streaming transform differs from x @ pc")
    return out


def phase_streaming_kmeans(x: torch.Tensor, truth: torch.Tensor, blocks: list, gen: torch.Generator) -> dict:
    """KMeans over host blocks through an iterator factory (streaming
    Lloyd, one pass an iteration, the plain route): warm-started against
    the in-memory ``xla`` fit from the same centers, and seeded from its
    reservoir against the planted blobs."""
    t_phase = time.perf_counter()
    c0 = near(truth, gen)
    mem = KMeans().setK(KM_K).setInitialModel(c0).setBackend("xla").fit(x)
    kk.reset_launches()
    t0 = time.perf_counter()
    warm = KMeans().setK(KM_K).setInitialModel(c0).fit(lambda: iter(blocks))
    warm_centers = warm.clusterCenters()
    warm_wall = time.perf_counter() - t0

    def seeded():
        return KMeans().setK(KM_K).setSeed(SEED).fit(lambda: iter(blocks))

    model = seeded()
    centers = model.clusterCenters()
    kernel_launches = dict(kk.launches)
    seeded_wall = wall_s(lambda: seeded().trainingCost)
    truth_np = truth.double().cpu().numpy()
    nearest = np.sqrt(((truth_np[:, None, :] - centers[None]) ** 2).sum(-1)).min(axis=1)
    out = {
        "phase": "streaming_kmeans", "x": [sum(b.shape[0] for b in blocks), int(blocks[0].shape[1]),
                                           str(blocks[0].dtype)],
        "blocks": len(blocks), "block_rows": int(blocks[0].shape[0]), "k": KM_K,
        "kernel_launches": kernel_launches,
        "warm": {"fit_wall_s": warm_wall, "num_iter": warm.numIter, "in_memory_num_iter": mem.numIter,
                 "centers_vs_in_memory_max_abs": float(np.abs(warm_centers - mem.clusterCenters()).max()),
                 "cost_vs_in_memory_rel": abs(warm.trainingCost - mem.trainingCost) / abs(mem.trainingCost)},
        "seeded": {"fit_wall_s": seeded_wall, "timing": "median of 3", "num_iter": model.numIter,
                   "planted_center_max_distance": float(nearest.max())},
    }
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    require(sum(kernel_launches.values()) == 0, "the streaming KMeans route launched K2 or K3")
    require(out["warm"]["centers_vs_in_memory_max_abs"] <= 1e-3, "streaming centers differ from the in-memory fit")
    require(out["warm"]["cost_vs_in_memory_rel"] <= 1e-4, "streaming cost differs from the in-memory fit")
    require(warm.numIter == mem.numIter, "streaming numIter differs from the in-memory fit")
    require(nearest.max() <= 1.0, f"a planted center is {nearest.max():.3f} from every fitted center")
    return out


def streaming_phases(gen: torch.Generator) -> None:
    """The wide and streaming phases, each freeing its data before the
    next: the wide tensor, then its rows as host blocks, then the streaming
    covariance rows, then the KMeans rows. Prints the four phases' wall
    with the making and copying of their data."""
    t0 = time.perf_counter()
    x = planted(WIDE_N, WIDE_D, gen)
    _, oracle, sketch_ev = phase_wide_pca(x)
    wide_host = x.cpu().numpy()
    del x
    oracle = {key: oracle[key] for key in ("cov", "w", "v", "total")}
    torch.cuda.empty_cache()
    blocks = [wide_host[i:i + WIDE_BLOCK] for i in range(0, WIDE_N, WIDE_BLOCK)]
    phase_streaming_wide_pca(blocks, oracle, sketch_ev)
    del wide_host, blocks, oracle
    torch.cuda.empty_cache()

    x = planted(ST_N, D, gen)
    host = x.cpu().numpy()
    blocks = [host[i:i + HOST_ROWS] for i in range(0, ST_N, HOST_ROWS)]
    phase_streaming_pca(x, blocks)
    del x, host, blocks
    torch.cuda.empty_cache()

    x, truth = planted_blobs(KM_N, KM_D, KM_K, gen)
    host = x.cpu().numpy()
    blocks = [host[i:i + KM_ST_BLOCK] for i in range(0, KM_N, KM_ST_BLOCK)]
    phase_streaming_kmeans(x, truth, blocks, gen)
    del x, host, blocks
    torch.cuda.empty_cache()
    emit({"phases": ["wide_pca", "streaming_wide_pca", "streaming_pca", "streaming_kmeans"],
          "wall_s": time.perf_counter() - t0})


# --- Linear, logistic, evaluation (no kernel of their own) ------------------

GLM_N = 11_000_000           # BASELINE configs 4 and 10: HIGGS-shaped rows
GLM_D = 28
GLM_BLOCK = 1_000_000        # rows per host block of the streaming fits (11 blocks)
EVAL_N = 10_000_000          # config 14's rows
F64_CHUNK = 1 << 20          # rows per chunk of the float64 references


def _kernel_launch_total() -> int:
    return k1.launches + sum(kk.launches.values()) + sum(k4.launches.values())


def _reset_kernel_launches() -> None:
    k1.reset_launches()
    kk.reset_launches()
    k4.reset_launches()


def glm_rows(gen: torch.Generator):
    """HIGGS-shaped rows on the card: 28 float32 features, each N(μ_j, s_j²)
    with μ_j ~ U(−0.5, 0.5) and s_j ~ U(0.5, 1.5), and a true weight
    vector w ~ N(0, 1)."""
    dev = gen.device
    mu = torch.rand(GLM_D, generator=gen, device=dev) - 0.5
    sd = torch.rand(GLM_D, generator=gen, device=dev) + 0.5
    x = torch.randn((GLM_N, GLM_D), generator=gen, device=dev)
    x.mul_(sd).add_(mu)
    w = torch.randn(GLM_D, generator=gen, device=dev)
    return x, w


def f64_moments(x: torch.Tensor, y: torch.Tensor, chunk: int = 0):
    """(XᵀX, Xᵀy, Σx, Σy, n) in float64 from row chunks of the same rows
    (``chunk`` rows each, default ``F64_CHUNK``)."""
    chunk = chunk or F64_CHUNK
    d = x.shape[1]
    xtx = torch.zeros((d, d), dtype=torch.float64, device=x.device)
    xty = torch.zeros(d, dtype=torch.float64, device=x.device)
    xs = torch.zeros(d, dtype=torch.float64, device=x.device)
    ys = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], chunk):
        b, yb = x[i:i + chunk].double(), y[i:i + chunk].double()
        xtx += b.T @ b
        xty += b.T @ yb
        xs += b.sum(dim=0)
        ys += yb.sum()
    return xtx.cpu().numpy(), xty.cpu().numpy(), xs.cpu().numpy(), float(ys), x.shape[0]


def ridge_f64(xtx, xty, xs, ys, n, reg):
    """Spark's normal-solver ridge (standardized penalty) in numpy float64:
    (Xcᵀ Xc + n·reg·diag(σ²)) b = Xcᵀ yc, b0 = ȳ − x̄ᵀb."""
    xm, ym = xs / n, ys / n
    a = xtx - n * np.outer(xm, xm)
    rhs = xty - n * xm * ym
    var = np.maximum((np.diag(xtx) - n * xm * xm) / (n - 1), 0.0)
    coef = np.linalg.solve(a + n * reg * np.diag(var), rhs)
    return coef, ym - xm @ coef


def _rel_max(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _host_blocks(x: torch.Tensor, rows: int) -> list:
    host = x.cpu().numpy()
    return [host[i:i + rows] for i in range(0, host.shape[0], rows)]


def phase_linreg(gen: torch.Generator, peaks) -> dict:
    """BASELINE config 4: ``LinearRegression().setRegParam(0.1)`` on an
    11M × 28 float32 tensor pair, held against a float64 solve of float64
    moments of the same rows; the elastic net (FISTA) against itself on a
    float64 copy; the ``dd`` route over 11 host blocks; ``predict`` and
    ``evaluate`` over all rows."""
    t_phase = time.perf_counter()
    x, w_true = glm_rows(gen)
    y = x @ w_true + 0.1 * torch.randn(GLM_N, generator=gen, device=x.device)
    _reset_kernel_launches()
    est = LinearRegression().setRegParam(0.1)
    model = est.fit((x, y))
    coef, b0 = model.coefficients, model.intercept
    fit_wall = wall_s(lambda: est.fit((x, y)).coefficients)
    stats64 = f64_moments(x, y)
    ref_coef, ref_b0 = ridge_f64(*stats64, 0.1)
    scale = float(np.abs(ref_coef).max())

    enet = LinearRegression().setRegParam(0.1).setElasticNetParam(0.5)
    fista0 = counter_value("linear.fista.iterations")
    t0 = time.perf_counter()
    m_enet = enet.fit((x, y))
    enet_coef = m_enet.coefficients
    enet_first = time.perf_counter() - t0
    fista_syncs = counter_value("linear.fista.iterations") - fista0
    enet_wall = wall_s(lambda: enet.fit((x, y)).coefficients)
    x64, y64 = x.double(), y.double()
    m_enet64 = enet.fit((x64, y64))
    del x64, y64
    torch.cuda.empty_cache()

    blocks = _host_blocks(x, GLM_BLOCK)
    y_host = y.cpu().numpy()
    t0 = time.perf_counter()
    m_dd = LinearRegression().setRegParam(0.1).setPrecision("dd").fit((blocks, y_host))
    dd_coef = m_dd.coefficients
    dd_wall = time.perf_counter() - t0
    del blocks, y_host

    t0 = time.perf_counter()
    pred = model.predict(x)
    sync()
    predict_wall = time.perf_counter() - t0
    coef_dev = torch.from_numpy(coef).to(x.device)
    pred_err, sse = 0.0, 0.0
    for i in range(0, GLM_N, F64_CHUNK):
        ref = x[i:i + F64_CHUNK].double() @ coef_dev + b0
        pred_err = max(pred_err, float((ref - pred[i:i + F64_CHUNK].double()).abs().max()))
        sse += float(((y[i:i + F64_CHUNK].double() - ref) ** 2).sum())
    rmse64 = float(np.sqrt(sse / GLM_N))
    summary = model.evaluate((x, y))
    launches = _kernel_launch_total()
    _, hbm, _, _ = peaks
    out = {
        "phase": "linreg", "config": "BASELINE config 4", "x": [GLM_N, GLM_D, str(x.dtype)],
        "estimator": "LinearRegression().setRegParam(0.1)",
        "fit_wall_s": fit_wall, "timing": "median of 3, host clock around fit and the coefficients' readback",
        "stats_bound_ms": GLM_N * GLM_D * 4 / hbm * 1e3,
        "stats_bound_by": "bytes (one read of x at the card's HBM rate)",
        "coef_vs_f64_solve_rel": _rel_max(coef, ref_coef),
        "intercept_vs_f64_solve_abs": abs(b0 - ref_b0) / scale,
        "enet": {"fit_wall_s": enet_wall, "fit_first_s": enet_first, "fista_iterations": fista_syncs,
                 "coef_vs_f64_copy_rel": _rel_max(enet_coef, m_enet64.coefficients)},
        "dd": {"fit_wall_s": dd_wall, "blocks": -(-GLM_N // GLM_BLOCK),
               "coef_vs_f64_solve_rel": _rel_max(dd_coef, ref_coef)},
        "predict_wall_s": predict_wall, "predict_max_abs_vs_f64": pred_err,
        "evaluate": summary, "rmse_f64_of_the_model": rmse64, "kernel_launches": launches,
    }
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    require(launches == 0, "the linear route launched a kernel")
    require(bool(np.isfinite(coef).all()) and coef.shape == (GLM_D,), "coefficients not finite (d,)")
    require(out["coef_vs_f64_solve_rel"] <= 1e-4, "config-4 coefficients differ from the float64 solve by > 1e-4")
    require(out["intercept_vs_f64_solve_abs"] <= 1e-4, "config-4 intercept differs from the float64 solve")
    require(out["enet"]["coef_vs_f64_copy_rel"] <= 1e-4, "elastic-net coefficients differ from the float64 copy's")
    require(out["dd"]["coef_vs_f64_solve_rel"] <= 1e-9, "dd coefficients differ from the float64 solve")
    require(pred.shape == (GLM_N,) and pred_err <= 1e-4, "predict differs from x·coef + b")
    require(abs(summary["rootMeanSquaredError"] - rmse64) <= 1e-5 * rmse64, "evaluate's rmse differs from float64")
    del x, y, pred
    torch.cuda.empty_cache()
    return out


def f64_stddev(x: torch.Tensor, chunk: int = 0) -> torch.Tensor:
    """Population stddev of each column in float64, from row chunks."""
    chunk = chunk or F64_CHUNK
    chunks = range(0, x.shape[0], chunk)
    mean = sum(x[i:i + chunk].double().sum(dim=0) for i in chunks) / x.shape[0]
    ss = sum(((x[i:i + chunk].double() - mean) ** 2).sum(dim=0) for i in chunks)
    return torch.sqrt(ss / x.shape[0])


def logistic_objective64(x: torch.Tensor, y: torch.Tensor, weights, intercepts, reg: float, sigma64,
                         chunk: int = 0) -> float:
    """The config's objective of an original-space solution, in float64 on
    the card: mean log-loss + reg/2 · Σ (w_j σ_j)² (the penalty on the
    standardized coefficients, σ the population stddev)."""
    chunk = chunk or F64_CHUNK
    w = torch.from_numpy(np.asarray(weights, dtype=np.float64)).to(x.device)
    b = torch.from_numpy(np.asarray(intercepts, dtype=np.float64)).to(x.device)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], chunk):
        logits = x[i:i + chunk].double() @ w + b
        yb = y[i:i + chunk].long()
        if w.shape[1] == 1:
            z = logits[:, 0]
            total += torch.sum(torch.logaddexp(z, torch.zeros((), dtype=z.dtype, device=z.device)) - (yb == 1) * z)
        else:
            total -= torch.sum(torch.log_softmax(logits, dim=1).gather(1, yb[:, None]))
    penalty = 0.5 * reg * float(((w * sigma64[:, None]) ** 2).sum())
    return float(total) / x.shape[0] + penalty


def _eval_ms(loss, w, b, repeats: int = 5) -> float:
    return time_ms(lambda: loss.value_and_grad(w, b), repeats=repeats, warmup=1)


class _StandardizedBlocks:
    """The reference's fused sweep for comparison: each row block
    standardized first (``ops.logistic._block_terms``)."""

    def __init__(self, x, target, mask, offset, scale, rows):
        self.args, self.rows = (x, target, mask, offset, scale), rows

    def value_and_grad(self, w, b):
        from spark_rapids_ml_tpu_torch.ops import logistic as ops_logistic

        x, target, mask, offset, scale = self.args
        acc = None
        for i in range(0, x.shape[0], self.rows):
            t = ops_logistic._block_terms(x[i:i + self.rows], target[i:i + self.rows], mask[i:i + self.rows],
                                          w, b, offset, scale, 1, True, torch.matmul)
            acc = t if acc is None else tuple(a + v for a, v in zip(acc, t))
        return acc


def logistic_block_sweep(x: torch.Tensor, y: torch.Tensor) -> dict:
    """Device time of one objective evaluation (value and gradient) at
    config 10's shape: the port's fused sweep (standardization folded into
    the weights) at three row blocks, the reference's form (each block
    standardized first) at its 65,536 rows and at the port's blocks, and
    the plain autograd objective."""
    from spark_rapids_ml_tpu_torch.ops import logistic as ops_logistic

    mask = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    offset, scale = ops_logistic._standardizer(x, mask, True, True)
    target = ops_logistic._targets(y.long(), 1, x.dtype)
    w = torch.full((x.shape[1], 1), 0.01, dtype=x.dtype, device=x.device)
    b = torch.zeros(1, dtype=x.dtype, device=x.device)
    out = {"default_block_rows": ops_logistic.FUSED_BLOCK_ROWS}
    for rows in (1 << 20, 1 << 22, x.shape[0]):
        loss = ops_logistic.LogisticLoss(x, target, mask, offset, scale, mask.sum(), 0.01, 1, True,
                                         torch.matmul, fused=True, block_rows=rows)
        out[f"folded_block_{rows}_ms"] = _eval_ms(loss, w, b)
    for rows in (65_536, 1 << 20, x.shape[0]):
        out[f"standardized_block_{rows}_ms"] = _eval_ms(_StandardizedBlocks(x, target, mask, offset, scale, rows),
                                                        w, b)
    plain = ops_logistic.LogisticLoss(x, target, mask, offset, scale, mask.sum(), 0.01, 1, True,
                                      torch.matmul, fused=False)
    out["plain_autograd_ms"] = _eval_ms(plain, w, b)
    # The least time: two reads of x (logits, then Xᵀdz) at the HBM rate.
    _, hbm, _, _ = peaks_for(torch.cuda.get_device_name(0)) if x.is_cuda else peaks_for("H100")
    out["two_reads_of_x_bound_ms"] = 2 * x.numel() * x.element_size() / hbm * 1e3
    return out


def _logreg_profile(est, x, y) -> dict:
    from torch.profiler import ProfilerActivity, profile

    est.fit((x, y)).weights  # warm
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.fit((x, y)).weights  # reading the weights waits for the fit
        sync()
        window_ms = (time.perf_counter() - t0) * 1e3
    device_ms = _device_ms_by_kernel(prof)
    busy_ms = sum(device_ms.values())
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:10]
    return {"window_ms": window_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / window_ms) if busy_ms else None,
            "top_device_ms": [{"kernel": k[:80], "ms": v} for k, v in top]}


def phase_logreg(gen: torch.Generator) -> dict:
    """BASELINE config 10: ``LogisticRegression().setRegParam(0.01)
    .setMaxIter(20).setTol(0.0)`` on 11M × 28 float32 rows with labels
    x·w + 0.5·noise > 0, held against the same fit on a float64 copy and a
    converged float64 fit; a 3-class multinomial fit and an elastic-net
    fit against their float64 twins; the streaming fit over 11 host
    blocks through a factory; ``predict`` on all rows; one fit profiled."""
    t_phase = time.perf_counter()
    x, w_true = glm_rows(gen)
    margin = (x - x.mean(dim=0)) / x.std(dim=0) @ w_true + 0.5 * torch.randn(GLM_N, generator=gen, device=x.device)
    y = (margin > 0).float()
    q = torch.quantile(margin[:1_000_000], torch.tensor([1 / 3, 2 / 3], device=x.device))
    y3 = torch.bucketize(margin, q).float()
    del margin
    _reset_kernel_launches()
    sigma64 = f64_stddev(x)

    est = LogisticRegression().setRegParam(0.01).setMaxIter(20).setTol(0.0)
    evals0 = counter_value("logistic.lbfgs.evaluations")
    t0 = time.perf_counter()
    model = est.fit((x, y))
    w32, b32 = model.weights, model.intercepts
    first_wall = time.perf_counter() - t0
    evals = counter_value("logistic.lbfgs.evaluations") - evals0
    fit_wall = wall_s(lambda: est.fit((x, y)).weights)
    sweep = logistic_block_sweep(x, y)
    profile = _logreg_profile(est, x, y)

    x64 = x.double()
    m64 = est.fit((x64, y))
    conv = LogisticRegression().setRegParam(0.01).setMaxIter(200).setTol(1e-9)
    t0 = time.perf_counter()
    m_conv = conv.fit((x64, y))
    conv_wall = time.perf_counter() - t0
    multi = LogisticRegression().setRegParam(0.01).setMaxIter(20).setTol(0.0)
    t0 = time.perf_counter()
    m3 = multi.fit((x, y3))
    w3 = m3.weights
    multi_wall = time.perf_counter() - t0
    m3_64 = multi.fit((x64, y3))
    enet = LogisticRegression().setRegParam(0.01).setElasticNetParam(0.5).setMaxIter(100)
    fista0 = counter_value("logistic.fista.iterations")
    t0 = time.perf_counter()
    m_enet = enet.fit((x, y))
    w_enet = m_enet.weights
    enet_wall = time.perf_counter() - t0
    fista_iters = counter_value("logistic.fista.iterations") - fista0
    m_enet64 = enet.fit((x64, y))
    del x64
    torch.cuda.empty_cache()

    obj = {
        "config10_f32": logistic_objective64(x, y, w32, b32, 0.01, sigma64),
        "converged_f64": logistic_objective64(x, y, m_conv.weights, m_conv.intercepts, 0.01, sigma64),
    }

    blocks = _host_blocks(x, GLM_BLOCK)
    y_host = y.cpu().numpy()
    passes0 = counter_value("logistic.stream.passes")
    t0 = time.perf_counter()
    m_stream = est.fit((lambda: iter(blocks), y_host))
    stream_wall = time.perf_counter() - t0
    stream_passes = counter_value("logistic.stream.passes") - passes0
    obj["streaming"] = logistic_objective64(x, y, m_stream.weights, m_stream.intercepts, 0.01, sigma64)
    del blocks, y_host

    t0 = time.perf_counter()
    labels = model.predict(x)
    sync()
    predict_wall = time.perf_counter() - t0
    w64t = torch.from_numpy(m64.weights).to(x.device)
    b64 = float(m64.intercepts[0])
    differ = near = 0
    for i in range(0, GLM_N, F64_CHUNK):
        z = (x[i:i + F64_CHUNK].double() @ w64t)[:, 0] + b64
        diff = labels[i:i + F64_CHUNK] != (z > 0).to(torch.int32)
        close = z.abs() <= 1e-5
        differ += int((diff & ~close).sum())
        near += int(close.sum())
    launches = _kernel_launch_total()
    scale = float(np.abs(m64.weights).max())
    out = {
        "phase": "logreg", "config": "BASELINE config 10", "x": [GLM_N, GLM_D, str(x.dtype)],
        "estimator": "LogisticRegression().setRegParam(0.01).setMaxIter(20).setTol(0.0)",
        "num_iter": model.numIter, "objective_evaluations": evals,
        "fit_wall_s": fit_wall, "fit_first_s": first_wall, "timing": "median of 3",
        "weights_vs_f64_copy_rel": _rel_max(w32, m64.weights),
        "intercept_vs_f64_copy_abs": abs(float(b32[0]) - b64) / scale,
        "objective": obj,
        "objective_vs_converged_rel": abs(obj["config10_f32"] - obj["converged_f64"]) / abs(obj["converged_f64"]),
        "converged_f64": {"num_iter": m_conv.numIter, "fit_wall_s": conv_wall},
        "multinomial": {"classes": m3.numClasses, "num_iter": m3.numIter, "fit_wall_s": multi_wall,
                        "weights_vs_f64_copy_rel": _rel_max(w3, m3_64.weights)},
        "elastic_net": {"fista_iterations": fista_iters, "fit_wall_s": enet_wall,
                        "weights_vs_f64_copy_rel": _rel_max(w_enet, m_enet64.weights)},
        "streaming": {"blocks": -(-GLM_N // GLM_BLOCK), "fit_wall_s": stream_wall, "num_iter": m_stream.numIter,
                      "device_passes": stream_passes,
                      "objective_vs_converged_rel": abs(obj["streaming"] - obj["converged_f64"]) / abs(
                          obj["converged_f64"])},
        "predict_wall_s": predict_wall, "labels_differing_from_f64": differ,
        "rows_within_1e-5_of_threshold": near,
        "objective_sweep": sweep, "profile": profile, "kernel_launches": launches,
    }
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    require(launches == 0, "the logistic route launched a kernel")
    require(model.numIter == 20, f"config 10 ran {model.numIter} iterations, not 20")
    require(bool(np.isfinite(w32).all()) and w32.shape == (GLM_D, 1), "weights not finite (d, 1)")
    require(out["weights_vs_f64_copy_rel"] <= 1e-3, "config-10 weights differ from the float64 copy's by > 1e-3")
    require(out["objective_vs_converged_rel"] <= 1e-4, "config-10 objective is > 1e-4 from the converged fit's")
    require(m3.numClasses == 3 and out["multinomial"]["weights_vs_f64_copy_rel"] <= 1e-3,
            "multinomial weights differ from the float64 copy's")
    require(out["elastic_net"]["weights_vs_f64_copy_rel"] <= 1e-3, "elastic-net weights differ from the float64 copy's")
    require(out["streaming"]["objective_vs_converged_rel"] <= 1e-4, "streaming objective is > 1e-4 from converged")
    require(labels.shape == (GLM_N,) and differ == 0, f"{differ} predicted labels differ from the float64 model's")
    del x, y, y3, labels
    torch.cuda.empty_cache()
    return out


def _auc_profile(ev, pair) -> dict:
    """One AUC evaluate under ``torch.profiler``: device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev.evaluate(pair)
        sync()
        window_ms = (time.perf_counter() - t0) * 1e3
    device_ms = _device_ms_by_kernel(prof)
    busy_ms = sum(device_ms.values())
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]
    return {"window_ms": window_ms, "device_busy_ms": busy_ms,
            "top_device_ms": [{"kernel": k[:80], "ms": v} for k, v in top]}


def phase_evaluators(gen: torch.Generator, peaks) -> dict:
    """BASELINE config 14: the three evaluators on 10M rows — scores
    s ~ U(0, 1) float32 and labels ~ Bernoulli(s) on the card — through
    the device route (a tensor pair), held against the port's host route
    on float64 numpy copies and, for the ROC, against 5/6 (its value
    under this law)."""
    from spark_rapids_ml_tpu_torch import evaluation

    t_phase = time.perf_counter()
    dev = gen.device
    s = torch.rand(EVAL_N, generator=gen, device=dev)
    y = (torch.rand(EVAL_N, generator=gen, device=dev) < s).float()
    p = (s > 0.5).float()
    _reset_kernel_launches()
    evals = {
        "areaUnderROC": (evaluation.BinaryClassificationEvaluator(), (y, s)),
        "areaUnderPR": (evaluation.BinaryClassificationEvaluator().setMetricName("areaUnderPR"), (y, s)),
        "rmse": (evaluation.RegressionEvaluator(), (y, s)),
        "accuracy": (evaluation.MulticlassClassificationEvaluator().setMetricName("accuracy"), (y, p)),
        "f1": (evaluation.MulticlassClassificationEvaluator(), (y, p)),
    }
    device_values = {k: ev.evaluate(pair) for k, (ev, pair) in evals.items()}
    walls = {k: wall_s(lambda ev=ev, pair=pair: ev.evaluate(pair)) for k, (ev, pair) in evals.items()}
    auc_profile = _auc_profile(evals["areaUnderROC"][0], (y, s))
    host_pairs = {k: tuple(t.cpu().numpy().astype(np.float64) for t in pair) for k, (_, pair) in evals.items()}
    threshold = evaluation._DEVICE_THRESHOLD
    evaluation._DEVICE_THRESHOLD = float("inf")  # the host route, whatever the size
    try:
        t0 = time.perf_counter()
        host_values = {k: ev.evaluate(host_pairs[k]) for k, (ev, _) in evals.items()}
        host_wall = time.perf_counter() - t0
    finally:
        evaluation._DEVICE_THRESHOLD = threshold
    _, hbm, _, _ = peaks
    sort_bytes = 2 * 8 * EVAL_N * np.log2(EVAL_N)
    launches = _kernel_launch_total()
    out = {
        "phase": "evaluators", "config": "BASELINE config 14", "rows": EVAL_N,
        "device": device_values, "host_float64": host_values, "host_wall_s_all_five": host_wall,
        "evaluate_wall_s": walls, "timing": "median of 3, device route on the tensor pair",
        "auc_sort_bound_ms": sort_bytes / hbm * 1e3, "auc_sort_bound": "2·8·N·log2(N) bytes at the HBM rate",
        "roc_minus_five_sixths": device_values["areaUnderROC"] - 5 / 6,
        "auc_profile": auc_profile,
        "kernel_launches": launches,
    }
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    require(launches == 0, "the evaluators launched a kernel")
    for k in ("areaUnderROC", "areaUnderPR"):
        require(abs(device_values[k] - host_values[k]) <= 1e-6, f"{k}: device route differs from the host route")
    require(abs(out["roc_minus_five_sixths"]) <= 2e-3, "ROC is not 5/6 under s ~ U(0,1), y ~ Bernoulli(s)")
    require(abs(device_values["rmse"] - host_values["rmse"]) <= 1e-6 * host_values["rmse"], "rmse differs")
    for k in ("accuracy", "f1"):
        require(abs(device_values[k] - host_values[k]) <= 1e-9, f"{k}: device route differs from the host route")
    del s, y, p
    torch.cuda.empty_cache()
    return out


def glm_phases(gen: torch.Generator, peaks) -> dict:
    """Configs 4, 10 and 14, each phase freeing its data before the next."""
    t0 = time.perf_counter()
    out = {"linreg": phase_linreg(gen, peaks), "logreg": phase_logreg(gen), "evaluators": phase_evaluators(gen, peaks)}
    wall = time.perf_counter() - t0
    emit({"phases": ["linreg", "logreg", "evaluators"], "wall_s": wall})
    require(wall <= 60.0, f"the three phases took {wall:.1f} s, over their 60 s")
    out["wall_s"] = wall
    return out


# --- The fit policy: packed PCA, the fit memory guard, the knobs ------------

PK_PARTS = 4                # host partitions of the packed fit
PK_ROWS = 65_536
PK_D = 128
PK_K = 16
GUARD_N = 1_048_576         # 1,048,576 x 1,024 float32 host rows: 4 GiB
GUARD_BUDGET = 1 << 30      # (a): 1 GiB, so the fit degrades
OOM_HEADROOM = 4 << 30      # (b): the ballast leaves 4 GiB free: too little for the
                            # in-memory fit's 8 GiB float64 copy, room for the
                            # streaming fit's ~1.5 GiB of blocks after the earlier
                            # phases' allocator state (2.5 GiB made it halve once)
SMALL_BUDGET = 256 << 20    # (c): configs 3, 4 and 10 under 256 MiB
GUARD_ITERS = 5             # (c): Lloyd / L-BFGS iterations of each pair of fits
HOST_INPUT_FITS = 1         # (e): host-input fits of the earlier phases (main_path's partitions)


class knob:
    """Set ``TPUML_*`` variables for a block and restore them after."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update({k: str(v) for k, v in self.values.items()})

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def planted_f64(n: int, d: int, top: int, gen: torch.Generator) -> torch.Tensor:
    """Float64 rows on the card: a decaying top ``top`` (s_i = 1 + 30·0.8^i)
    over unit noise, rotated by a random orthogonal Q and shifted."""
    dev = torch.device("cuda")
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=gen, device=dev, dtype=torch.float64))
    s = torch.ones(d, dtype=torch.float64, device=dev)
    s[:top] += 30.0 * 0.8 ** torch.arange(top, dtype=torch.float64, device=dev)
    z = torch.randn((n, d), generator=gen, device=dev, dtype=torch.float64)
    return (z * s) @ q.T + 3.0 * torch.randn(d, generator=gen, device=dev, dtype=torch.float64)


def _fit_vs(model, ref) -> dict:
    return {"pc_max_abs": _pc_err_aligned(model.pc, ref.pc),
            "ev_max_abs": float(np.abs(model.explainedVariance - ref.explainedVariance).max())}


def _same_pca(a, b) -> bool:
    return np.array_equal(a.pc, b.pc) and np.array_equal(a.explainedVariance, b.explainedVariance)


def phase_packed_pca(gen: torch.Generator) -> dict:
    """``PCA().setK(16).setUseGemm(False)`` on 4 host float64 partitions of
    65,536 × 128 through the native spr accumulator (counter
    ``pca.packed.native``), then the same rows as a ``.npy`` through
    ``NpyBlockReader``, by the packed and the GEMM streaming routes; each
    held against an on-card float64 fit of the same rows, its wall beside
    the card's float64 Gram of those rows."""
    n = PK_PARTS * PK_ROWS
    x = planted_f64(n, PK_D, PK_K, gen)
    ref = PCA().setK(PK_K).fit(x)
    host = x.cpu().numpy()
    parts = [host[i * PK_ROWS:(i + 1) * PK_ROWS] for i in range(PK_PARTS)]
    t0 = time.perf_counter()
    lib = native.get_lib()
    build_s = time.perf_counter() - t0
    require(lib is not None, f"the native host library did not build: {native.build_error()}")
    est = PCA().setK(PK_K).setUseGemm(False)
    walls, fits = {}, {}
    native0, device0 = counter_value("pca.packed.native"), counter_value("pca.packed.device")
    t0 = time.perf_counter()
    fits["partitions"] = est.fit(parts)
    walls["partitions"] = time.perf_counter() - t0
    require(counter_value("pca.packed.native") - native0 == 1, "the partition fit did not take the native route")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rows.npy")
        np.save(path, host)
        with native.NpyBlockReader(path, block_rows=PK_ROWS) as reader:
            require(reader.shape == (n, PK_D) and reader.dtype == np.float64, "NpyBlockReader shape/dtype")
            t0 = time.perf_counter()
            fits["npy_packed"] = est.fit(reader)
            walls["npy_packed"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            fits["npy_gemm"] = PCA().setK(PK_K).fit(reader)
            walls["npy_gemm"] = time.perf_counter() - t0
    require(counter_value("pca.packed.native") - native0 == 2, "the npy packed fit did not take the native route")
    require(counter_value("pca.packed.device") == device0, "a packed fit took the device route")
    mean = x.mean(dim=0)
    gram_ms = time_ms(lambda: f64_gram(x, mean), repeats=5)
    out = {"phase": "packed_pca", "rows": [n, PK_D], "k": PK_K, "native_build_s": build_s,
           "fit_wall_s": walls, "rows_per_s": {k: n / v for k, v in walls.items()},
           "f64_gram_ms": gram_ms, "vs_f64": {k: _fit_vs(m, ref) for k, m in fits.items()}}
    emit(out)
    for name, err in out["vs_f64"].items():
        require(err["pc_max_abs"] <= 1e-8, f"packed_pca {name}: components {err['pc_max_abs']:.3e} > 1e-8")
        require(err["ev_max_abs"] <= 1e-10, f"packed_pca {name}: ratios {err['ev_max_abs']:.3e} > 1e-10")
    return out


def _guard_counts() -> dict:
    names = ("fit.admission.admitted", "fit.admission.degraded", "fit.admission.rejected",
             "fit.oom.events", "fit.oom.recovered")
    return {n: counter_value(n) for n in names}


def _delta(before: dict) -> dict:
    return {k: counter_value(k) - v for k, v in before.items()}


def _degraded(fit, what: str):
    """``fit()`` must degrade: one ``fit.admission.degraded`` and one
    ``DegradationWarning``."""
    before = _guard_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        model = fit()
        wall = time.perf_counter() - t0
    require(_delta(before)["fit.admission.degraded"] == 1, f"{what}: not degraded")
    require(any(isinstance(w.message, DegradationWarning) for w in caught), f"{what}: no DegradationWarning")
    return model, wall


def _raises_fit_memory_error(fit, what: str) -> str:
    try:
        fit()
    except membudget.FitMemoryError as exc:
        return str(exc)
    raise RuntimeError(f"chip smoke check failed: {what} did not raise FitMemoryError")


def _close_serving_programs() -> None:
    """Close the serving program cache of the earlier phases before a
    ballast: the OOM recovery's reclaim closes it too, and the checks that
    the failed attempt's memory is gone compare the bytes allocated when
    the fallback starts with those before the fit, exactly. A graph's
    pool also holds free blocks that ``free_hbm_bytes`` would count as
    usable."""
    from spark_rapids_ml_tpu_torch.core import serving as core_serving

    core_serving.clear_program_cache()


def phase_fit_guard(gen: torch.Generator) -> dict:
    """The fit memory guard on the card: (a) a 4 GiB host PCA over a 1 GiB
    budget degrades, bitwise equal to the explicit ``HostArrayBlockReader``
    fit; (b) a real OOM under a ballast is recovered after the failed
    attempt's memory was freed, equal to (a); (c) KMeans, linear and
    logistic at configs 3, 4 and 10's shapes under 256 MiB degrade,
    bitwise equal to their explicit streaming fits, and ``fused`` KMeans
    is refused; (d) UMAP at config 13's shape under 1 MiB is refused."""
    out = {"phase": "fit_guard"}
    x = planted(GUARD_N, D, gen)
    host = x.cpu().numpy()
    del x
    torch.cuda.empty_cache()
    with knob(TPUML_FIT_MEM_BUDGET=GUARD_BUDGET):
        model_a, wall_a = _degraded(lambda: PCA().setK(K).fit(host), "(a) PCA 4 GiB")
    t0 = time.perf_counter()
    explicit = PCA().setK(K).fit(HostArrayBlockReader(host))
    out["a"] = {"degraded_wall_s": wall_a, "explicit_wall_s": time.perf_counter() - t0,
                "bitwise_equal": _same_pca(model_a, explicit)}
    require(out["a"]["bitwise_equal"], "(a) the degraded PCA differs from the explicit reader's fit")

    # (b) A ballast leaves OOM_HEADROOM free, so the in-memory fit's float64
    # copy of the rows cannot be placed; the budget admits it anyway.
    _close_serving_programs()
    torch.cuda.empty_cache()
    free = membudget.free_hbm_bytes()
    ballast = torch.empty(free - OOM_HEADROOM, dtype=torch.uint8, device="cuda")
    at_fallback = {}
    run_streaming = membudget.run_streaming_with_recovery

    def watched(*args, **kwargs):
        at_fallback["allocated"] = torch.cuda.memory_allocated()
        return run_streaming(*args, **kwargs)

    allocated0 = torch.cuda.memory_allocated()
    before = _guard_counts()
    membudget.run_streaming_with_recovery = watched
    try:
        with knob(TPUML_FIT_MEM_BUDGET=1 << 40), warnings.catch_warnings():
            warnings.simplefilter("ignore", DegradationWarning)
            t0 = time.perf_counter()
            model_b = PCA().setK(K).fit(host)
            wall_b = time.perf_counter() - t0
    finally:
        membudget.run_streaming_with_recovery = run_streaming
    counts = _delta(before)
    del ballast
    torch.cuda.empty_cache()
    out["b"] = {"free_before_ballast": free, "headroom": OOM_HEADROOM, "wall_s": wall_b, "counters": counts,
                "allocated_before_fit": allocated0, "allocated_at_fallback": at_fallback.get("allocated"),
                "bitwise_equal_a": _same_pca(model_b, model_a)}
    emit({"phase": "fit_guard", "a": out["a"], "b": out["b"]})
    require(counts["fit.oom.events"] == 1 and counts["fit.oom.recovered"] == 1,
            f"(b) the OOM was not recovered once: {counts}")
    require(at_fallback.get("allocated") == allocated0,
            "(b) the failed attempt's memory was still held when the fallback started")
    require(out["b"]["bitwise_equal_a"], "(b) the recovered PCA differs from (a)")
    del host

    # (c) Configs 3, 4 and 10 under a 256 MiB budget.
    xk, _ = planted_blobs(KM_N, KM_D, KM_K, gen)
    xk_host = xk.cpu().numpy()
    del xk
    km = KMeans().setK(KM_K).setSeed(SEED).setMaxIter(GUARD_ITERS).setBackend("xla")
    with knob(TPUML_FIT_MEM_BUDGET=SMALL_BUDGET):
        m_km, wall_km = _degraded(lambda: km.fit(xk_host), "(c) KMeans")
        fused_msg = _raises_fit_memory_error(
            lambda: KMeans().setK(KM_K).setSeed(SEED).setBackend("fused").fit(xk_host), "(c) fused KMeans")
    e_km = km.fit(HostArrayBlockReader(xk_host))
    same_km = (np.array_equal(m_km.clusterCenters(), e_km.clusterCenters())
               and m_km.trainingCost == e_km.trainingCost)
    del xk_host
    xg, w_true = glm_rows(gen)
    yg = (xg @ w_true + 0.5 * torch.randn(GLM_N, generator=gen, device=xg.device) > 0).float()
    xg_host, yg_host = xg.cpu().numpy(), yg.cpu().numpy()
    del xg, yg
    torch.cuda.empty_cache()
    lin = LinearRegression().setRegParam(0.1)
    logit = LogisticRegression().setRegParam(0.01).setMaxIter(GUARD_ITERS).setTol(0.0)
    with knob(TPUML_FIT_MEM_BUDGET=SMALL_BUDGET):
        m_lin, wall_lin = _degraded(lambda: lin.fit((xg_host, yg_host)), "(c) LinearRegression")
        m_log, wall_log = _degraded(lambda: logit.fit((xg_host, yg_host)), "(c) LogisticRegression")
    e_lin = lin.fit((HostArrayBlockReader(xg_host), yg_host))
    e_log = logit.fit((HostArrayBlockReader(xg_host), yg_host))
    out["c"] = {
        "kmeans": {"wall_s": wall_km, "bitwise_equal": same_km, "fused_refused": fused_msg},
        "linear": {"wall_s": wall_lin, "bitwise_equal": bool(
            np.array_equal(m_lin.coefficients, e_lin.coefficients) and m_lin.intercept == e_lin.intercept)},
        "logistic": {"wall_s": wall_log, "bitwise_equal": bool(
            np.array_equal(m_log.weights, e_log.weights) and np.array_equal(m_log.intercepts, e_log.intercepts)
            and m_log.numIter == e_log.numIter)},
    }
    del xg_host, yg_host
    for fam in ("kmeans", "linear", "logistic"):
        require(out["c"][fam]["bitwise_equal"], f"(c) the degraded {fam} fit differs from the explicit reader's")

    # (d) UMAP has no streaming fit: over budget is a FitMemoryError.
    truth = UM_SCALE * torch.randn((UM_BLOBS, UM_D), generator=gen, device="cuda")
    xu, _ = umap_blobs(UM_N, truth, gen)
    with knob(TPUML_FIT_MEM_BUDGET=1 << 20):
        out["d"] = {"umap_refused": _raises_fit_memory_error(
            lambda: umap_estimator().fit(xu.cpu().numpy()), "(d) UMAP")}
    emit({"phase": "fit_guard", "c": out["c"], "d": out["d"]})
    del xu
    torch.cuda.empty_cache()
    out["f"] = fit_guard_tensor_oom(gen)
    return out


def _peak_extra_bytes(fit):
    """``(fit(), the most device bytes it held beyond those allocated
    before it)``."""
    sync()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    result = fit()
    sync()
    return result, torch.cuda.max_memory_allocated() - base


def fit_guard_tensor_oom(gen: torch.Generator) -> dict:
    """(f) A 1,048,576 x 1,024 float32 CUDA tensor that meets a real OOM
    in ``PCA().setK(16).fit`` is copied to the host and streamed. The
    ballast leaves the midpoint between the two fits' peaks, each measured
    here without a ballast: the in-memory fit (its centered copy of the
    rows) cannot run there, the streaming fit (one block at a time) can.
    The recovered fit must be bitwise the explicit reader fit of
    ``x.cpu().numpy()``, with the failed attempt's memory freed."""
    x = planted(GUARD_N, D, gen)
    host = x.cpu().numpy()
    _, peak_in_memory = _peak_extra_bytes(lambda: PCA().setK(K).fit(x).pc)
    explicit, peak_stream = _peak_extra_bytes(lambda: PCA().setK(K).fit(HostArrayBlockReader(host)))
    require(peak_stream < peak_in_memory,
            f"(f) the streaming fit's peak {peak_stream} is not below the in-memory fit's {peak_in_memory}")
    headroom = (peak_stream + peak_in_memory) // 2
    _close_serving_programs()
    torch.cuda.empty_cache()
    free = membudget.free_hbm_bytes()
    ballast = torch.empty(free - headroom, dtype=torch.uint8, device="cuda")
    at_fallback = {}
    run_streaming = membudget.run_streaming_with_recovery

    def watched(*args, **kwargs):
        at_fallback["allocated"] = torch.cuda.memory_allocated()
        return run_streaming(*args, **kwargs)

    allocated0 = torch.cuda.memory_allocated()
    before = _guard_counts()
    membudget.run_streaming_with_recovery = watched
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DegradationWarning)
            t0 = time.perf_counter()
            model = PCA().setK(K).fit(x)
            wall = time.perf_counter() - t0
    finally:
        membudget.run_streaming_with_recovery = run_streaming
    counts = _delta(before)
    del ballast, x, host
    torch.cuda.empty_cache()
    out = {"peak_in_memory": peak_in_memory, "peak_stream": peak_stream, "headroom": headroom,
           "free_before_ballast": free, "wall_s": wall, "counters": counts,
           "allocated_before_fit": allocated0, "allocated_at_fallback": at_fallback.get("allocated"),
           "bitwise_equal_explicit": _same_pca(model, explicit)}
    emit({"phase": "fit_guard", "f": out})
    require(counts["fit.oom.events"] == 1 and counts["fit.oom.recovered"] == 1,
            f"(f) the tensor's OOM was not recovered once: {counts}")
    require(at_fallback.get("allocated") == allocated0,
            "(f) the failed attempt's memory was still held when the fallback started")
    require(out["bitwise_equal_explicit"], "(f) the recovered tensor fit differs from the explicit reader's")
    return out


def phase_knobs(gen: torch.Generator) -> dict:
    """``TPUML_PRECISION_PCA``, ``TPUML_UMAP_SCATTER`` and
    ``TPUML_LOGISTIC_FUSED`` on the card, each against its explicit twin."""
    x = planted_f64(PK_PARTS * PK_ROWS, PK_D, PK_K, gen).float()
    explicit = PCA().setK(PK_K).setPrecision("bf16x3").fit(x)
    with knob(TPUML_PRECISION_PCA="bf16x3"):
        by_knob = PCA().setK(PK_K).fit(x)
    plain = PCA().setK(PK_K).fit(x)
    pca = {"bitwise_equal": _same_pca(by_knob, explicit), "differs_from_f32": not _same_pca(plain, explicit)}
    del x

    truth = UM_SCALE * torch.randn((UM_BLOBS, UM_D), generator=gen, device="cuda")
    xu, _ = umap_blobs(UM_N, truth, gen)
    sub = torch.randperm(UM_N, generator=gen, device=xu.device)[:UM_SUB]
    umap = {}
    for route in ("pallas", "xla"):
        k4.reset_launches()
        with knob(TPUML_UMAP_SCATTER=route):
            t0 = time.perf_counter()
            emb = umap_estimator().fit(xu)._emb_raw
            sync()
            wall = time.perf_counter() - t0
        umap[route] = {"launches": k4.launches["tail_accumulate"], "wall_s": wall,
                       "trustworthiness": _umap_trust(xu, emb, sub)}
    del xu

    xg, w_true = glm_rows(gen)
    y = ((xg - xg.mean(dim=0)) / xg.std(dim=0) @ w_true
         + 0.5 * torch.randn(GLM_N, generator=gen, device=xg.device) > 0).float()
    sigma64 = f64_stddev(xg)
    logit = {}
    for fused in ("1", "0"):
        with knob(TPUML_LOGISTIC_FUSED=fused):
            t0 = time.perf_counter()
            m = LogisticRegression().setRegParam(0.01).setMaxIter(20).setTol(0.0).fit((xg, y))
            w, b = m.weights, m.intercepts
            wall = time.perf_counter() - t0
        logit[fused] = {"numIter": m.numIter, "wall_s": wall,
                        "objective": logistic_objective64(xg, y, w, b, 0.01, sigma64)}
    del xg, y
    torch.cuda.empty_cache()
    obj_rel = abs(logit["0"]["objective"] - logit["1"]["objective"]) / abs(logit["1"]["objective"])
    out = {"phase": "knobs", "precision_pca": pca, "umap_scatter": umap,
           "logistic_fused": logit, "logistic_objective_rel": obj_rel}
    emit(out)
    require(pca["bitwise_equal"], "TPUML_PRECISION_PCA=bf16x3 differs from setPrecision('bf16x3')")
    require(umap["xla"]["launches"] == 0, "TPUML_UMAP_SCATTER=xla launched K4")
    require(umap["pallas"]["launches"] == UM_EPOCHS, "TPUML_UMAP_SCATTER=pallas did not launch K4 every epoch")
    require(abs(umap["xla"]["trustworthiness"] - umap["pallas"]["trustworthiness"]) <= 0.03,
            "TPUML_UMAP_SCATTER=xla trustworthiness is not within 0.03 of K4's")
    require(logit["0"]["numIter"] == logit["1"]["numIter"], "TPUML_LOGISTIC_FUSED=0 changed numIter")
    require(obj_rel <= 1e-4, f"TPUML_LOGISTIC_FUSED=0 objective {obj_rel:.3e} from the fused fit's, > 1e-4")
    return out


def fit_policy_phases(gen: torch.Generator) -> dict:
    """The packed PCA route, the fit memory guard and the knobs; each phase
    frees its data before the next. Prints their walls."""
    t0 = time.perf_counter()
    walls = {}
    out = {}
    for name, phase in (("packed_pca", phase_packed_pca), ("fit_guard", phase_fit_guard), ("knobs", phase_knobs)):
        t = time.perf_counter()
        out[name] = phase(gen)
        walls[name] = time.perf_counter() - t
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    emit({"phases": list(walls), "wall_s": wall, "phase_wall_s": walls})
    require(wall <= 90.0, f"the three phases took {wall:.1f} s, over their 90 s")
    return out


NB_N = 1_000_000            # BASELINE configs 7 and 11: 1M x 96 float32 items
NB_D = 96
NB_Q = 10_000               # their 10,000 queries
NB_K = 10
NB_LISTS = 1024             # config 7's ivfflat: nlist 1024, nprobe 32
NB_PROBE = 32
NB_FULL_Q = 1_000           # (b): queries of the nprobe = nlist check
PQ_D = 128                  # config 8: 1M x 128 items, 2,000 queries
PQ_Q = 2_000
PQ_PARAMS = {"nlist": 512, "nprobe": 16, "M": 32, "kmeans_iters": 3, "pq_iters": 3}
PQ_ADC_Q = 200              # (c): queries of the float64 ADC check
PQ_BLOCK = 262_144          # (c): rows per host block of the streamed brute index
SAVE_N = 50_000             # (d): items of the saved ivfflat model (a 1M-item model's
                            # vector rows took 98.7 s to save and load)
SAVE_PARAMS = {"nlist": 64, "nprobe": 8}
NB_F64_CHUNK = 512          # query rows per chunk of the float64 brute force
NB_WALL_LIMIT_S = 60.0


def knn_f64(queries: torch.Tensor, items: torch.Tensor, k: int, metric: str = "euclidean"):
    """Exact top-k in float64 on the card, ``NB_F64_CHUNK`` queries at a time:
    (distances under ``metric``, indices)."""
    q64, x64 = queries.double(), items.double()
    if metric == "cosine":
        q64 = q64 / q64.norm(dim=1, keepdim=True)
        x64 = x64 / x64.norm(dim=1, keepdim=True)
    x_sq = (x64 * x64).sum(dim=1)
    out_d, out_i = [], []
    for s in range(0, q64.shape[0], NB_F64_CHUNK):
        qb = q64[s:s + NB_F64_CHUNK]
        d2 = ((qb * qb).sum(dim=1)[:, None] - 2.0 * (qb @ x64.T) + x_sq[None, :]).clamp_min_(0.0)
        d, i = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        out_d.append(d)
        out_i.append(i)
        del d2
    d2 = torch.cat(out_d)
    dist = {"euclidean": d2.sqrt(), "sqeuclidean": d2, "cosine": d2 / 2.0}[metric]
    return dist, torch.cat(out_i)


def recall_of(idx: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of the reference's neighbours that ``idx`` found, row by row."""
    hits = (idx.long()[:, :, None] == ref.long()[:, None, :]).any(dim=2).sum()
    return float(hits) / ref.numel()


def rel_err(d: torch.Tensor, ref: torch.Tensor) -> float:
    return float(((d.double() - ref.double()).abs() / ref.double().abs().clamp_min(1e-30)).max())


def _knn_split(prof) -> dict:
    """Device ms of one exact search by kind: the distance GEMM, the
    int64 merge keys, ``topk`` and the rest."""
    split = {"gemm": 0.0, "key_build": 0.0, "topk": 0.0, "rest": 0.0}
    for key, ms in _device_ms_by_kernel(prof).items():
        name = key.lower()
        if any(t in name for t in ("gemm", "cutlass", "xmma", "sm90_")):
            split["gemm"] += ms
        elif any(t in name for t in ("topk", "radix", "sort", "bitonic")):
            split["topk"] += ms
        elif any(t in name for t in ("bitwise", "shift")) or ("copy" in name and "int" in name):
            split["key_build"] += ms
        else:
            split["rest"] += ms
    return split


def phase_exact_knn(items: torch.Tensor, queries: torch.Tensor, peaks) -> dict:
    """(a) BASELINE config 11: ``NearestNeighbors().setK(10)`` on 1M x 96
    float32 CUDA items, 10,000 queries, euclidean then cosine, against an
    on-card float64 brute force; timed (median of 3) beside the distance
    GEMM's operations bound and split by kernel kind under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    out = {"phase": "neighbours_exact", "what": "NearestNeighbors().setK(10), 1M x 96 f32, 10,000 queries"}
    _, _, fp32, _ = peaks
    out["gemm_bound_ms"] = 2.0 * NB_Q * NB_N * NB_D / fp32 * 1e3
    refs = {}
    for metric in ("euclidean", "cosine"):
        model = NearestNeighbors().setK(NB_K).setMetric(metric).fit(items)
        d, idx = model.kneighbors(queries)
        require(d.is_cuda and idx.is_cuda and idx.dtype == torch.int32 and tuple(idx.shape) == (NB_Q, NB_K),
                f"(a) {metric}: kneighbors did not return (10,000, 10) CUDA tensors")
        wall = wall_s(lambda: model.kneighbors(queries))
        t0 = time.perf_counter()
        d64, i64 = knn_f64(queries, items, NB_K, metric)
        ref_s = time.perf_counter() - t0
        refs[metric] = i64
        got = {"wall_s": wall, "queries_per_s": NB_Q / wall, "recall_vs_f64": recall_of(idx, i64),
               "dist_rel_vs_f64": rel_err(d, d64), "f64_reference_s": ref_s}
        out[metric] = got
        require(got["recall_vs_f64"] >= 0.999, f"(a) {metric} recall {got['recall_vs_f64']} < 0.999")
        require(got["dist_rel_vs_f64"] <= 1e-4, f"(a) {metric} distances {got['dist_rel_vs_f64']:.2e} > 1e-4")
        if metric == "euclidean":
            sync()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.kneighbors(queries)
                sync()
                window_ms = (time.perf_counter() - t0) * 1e3
            split = _knn_split(prof)
            busy = sum(split.values())
            top = sorted(_device_ms_by_kernel(prof).items(), key=lambda kv: -kv[1])[:8]
            out["profile"] = {"window_ms": window_ms, "device_busy_ms": busy, "split_ms": split,
                              "device_idle_share": 1.0 - busy / window_ms,
                              "top_device_ms": [{"kernel": k[:80], "ms": v} for k, v in top]}
    emit(out)
    out["refs"] = refs
    return out


def phase_ann_config7(items: torch.Tensor, queries: torch.Tensor, exact: torch.Tensor) -> dict:
    """(b) BASELINE config 7: ``ApproximateNearestNeighbors().setK(10)
    .setMetric("sqeuclidean")`` with ``brute``, ``brute_approx`` and
    ``ivfflat`` (nlist 1024, nprobe 32) on the same items. The quantizer's
    final assignment must take the row-blocked route (4·n·nlist > 2e9);
    ``nprobe = nlist`` on 1,000 queries must be exact."""
    out = {"phase": "neighbours_config7"}
    res = {}
    for algo in ("brute", "brute_approx"):
        model = ApproximateNearestNeighbors().setK(NB_K).setMetric("sqeuclidean").setAlgorithm(algo).fit(items)
        d, idx = model.kneighbors(queries)
        res[algo] = idx
        wall = wall_s(lambda: model.kneighbors(queries), repeats=1)
        out[algo] = {"wall_s": wall, "queries_per_s": NB_Q / wall, "recall_vs_exact": recall_of(idx, exact)}
    require(torch.equal(res["brute_approx"], res["brute"]), "(b) brute_approx indices differ from brute's")
    blocked0 = counter_value("ann.quantizer.blocked_assign")
    est = (ApproximateNearestNeighbors().setK(NB_K).setMetric("sqeuclidean")
           .setAlgoParams({"nlist": NB_LISTS, "nprobe": NB_PROBE}))
    sync()
    t0 = time.perf_counter()
    model = est.fit(items)
    sync()
    build_s = time.perf_counter() - t0
    blocked = counter_value("ann.quantizer.blocked_assign") - blocked0
    d, idx = model.kneighbors(queries)
    search = wall_s(lambda: model.kneighbors(queries))
    l_max = int(model._index.lists.shape[1])
    model.set(model.algoParams, {"nlist": NB_LISTS, "nprobe": NB_LISTS})
    sync()
    t0 = time.perf_counter()
    _, idx_full = model.kneighbors(queries[:NB_FULL_Q])
    sync()
    full_s = time.perf_counter() - t0
    model.set(model.algoParams, {"nlist": NB_LISTS, "nprobe": NB_PROBE})
    out["ivfflat"] = {"build_wall_s": build_s, "search_wall_s": search, "queries_per_s": NB_Q / search,
                      "recall_vs_exact": recall_of(idx, exact), "l_max": l_max,
                      "mean_list": NB_N / NB_LISTS, "blocked_assign": blocked,
                      "full_probe_wall_s": full_s,
                      "full_probe_recall_vs_brute": recall_of(idx_full, res["brute"][:NB_FULL_Q])}
    emit(out)
    require(blocked == 1, "(b) the quantizer's assignment did not take the blocked route")
    require(out["ivfflat"]["full_probe_recall_vs_brute"] >= 0.999, "(b) nprobe = nlist recall < 0.999")
    return out


def adc_f64(index, queries: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The index's own ADC distance of each returned item, recomputed in
    float64 from its centroids, codebooks and codes."""
    n_lists, l_max, m_sub = index.codes.shape
    ds = index.codebooks.shape[2]
    flat_ids = index.list_ids.reshape(-1).long()
    slot = torch.full((int(flat_ids.max()) + 1,), -1, dtype=torch.long, device=flat_ids.device)
    real = flat_ids >= 0
    slot[flat_ids[real]] = torch.nonzero(real)[:, 0]
    where = slot[idx.long()]  # (q, k) flat slot of each returned item
    codes = index.codes.reshape(-1, m_sub)[where].long()  # (q, k, M)
    cents = index.centroids.double()[where // l_max]  # (q, k, d)
    resid = (queries.double()[:, None, :] - cents).reshape(*where.shape, m_sub, ds)
    books = index.codebooks.double()  # (M, K, ds)
    picked = books[torch.arange(m_sub, device=codes.device)[None, None, :], codes]  # (q, k, M, ds)
    return ((resid - picked) ** 2).sum(dim=(2, 3))


def phase_ann_config8(gen: torch.Generator) -> dict:
    """(c) BASELINE config 8: 1M x 128 float32 items, 2,000 queries.
    ``ivfpq`` (nlist 512, nprobe 16, M 32, 3 + 3 iterations, no refine):
    build, search, recall, uint8 codes and a float64 ADC check; then
    ``refine_ratio`` 4; then a streamed brute index over host blocks of
    262,144 rows against the resident ``brute``."""
    from torch.profiler import ProfilerActivity, profile

    items = torch.randn((NB_N, PQ_D), generator=gen, device="cuda")
    queries = torch.randn((PQ_Q, PQ_D), generator=gen, device="cuda")
    _, exact = knn_f64(queries, items, NB_K, "sqeuclidean")
    out = {"phase": "neighbours_config8"}
    est = ApproximateNearestNeighbors().setK(NB_K).setMetric("sqeuclidean").setAlgorithm("ivfpq")
    sync()
    t0 = time.perf_counter()
    model = est.setAlgoParams(PQ_PARAMS).fit(items)
    sync()
    build_s = time.perf_counter() - t0
    d, idx = model.kneighbors(queries)
    search = wall_s(lambda: model.kneighbors(queries))
    index = model._index
    adc = adc_f64(index, queries[:PQ_ADC_Q], idx[:PQ_ADC_Q])
    model.set(model.algoParams, dict(PQ_PARAMS, refine_ratio=4))
    _, idx_refined = model.kneighbors(queries)
    refined = wall_s(lambda: model.kneighbors(queries))
    out["ivfpq"] = {"build_wall_s": build_s, "search_wall_s": search, "queries_per_s": PQ_Q / search,
                    "recall_vs_exact": recall_of(idx, exact), "codes_dtype": str(index.codes.dtype),
                    "l_max": int(index.codes.shape[1]), "adc_rel_vs_f64": rel_err(d[:PQ_ADC_Q], adc),
                    "refine4_wall_s": refined, "refine4_recall_vs_exact": recall_of(idx_refined, exact)}
    del model, index
    torch.cuda.empty_cache()

    resident = ApproximateNearestNeighbors().setK(NB_K).setAlgorithm("brute").fit(items)
    d_res, i_res = resident.kneighbors(queries)
    res_wall = wall_s(lambda: resident.kneighbors(queries))
    host = items.cpu().numpy()
    blocks = [host[i:i + PQ_BLOCK] for i in range(0, NB_N, PQ_BLOCK)]
    streamed = ApproximateNearestNeighbors().setK(NB_K).setAlgorithm("brute").fit(lambda: iter(blocks))
    d_st, i_st = streamed.kneighbors(queries)
    st_wall = wall_s(lambda: streamed.kneighbors(queries))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        streamed.kneighbors(queries)
        sync()
        window_ms = (time.perf_counter() - t0) * 1e3
    out["streamed_brute"] = {"blocks": len(blocks), "wall_s": st_wall, "queries_per_s": PQ_Q / st_wall,
                             "resident_wall_s": res_wall, "recall_vs_resident": recall_of(i_st, i_res),
                             "dist_rel_vs_resident": rel_err(d_st, d_res),
                             "h2d_share": _h2d_ms(prof) / window_ms, "window_ms": window_ms}
    emit(out)
    pq = out["ivfpq"]
    require(pq["codes_dtype"] == "torch.uint8", "(c) ivfpq codes are not uint8")
    require(pq["adc_rel_vs_f64"] <= 1e-4, f"(c) ADC distances {pq['adc_rel_vs_f64']:.2e} from float64 > 1e-4")
    require(pq["refine4_recall_vs_exact"] >= pq["recall_vs_exact"], "(c) refine_ratio 4 lowered the recall")
    sb = out["streamed_brute"]
    require(sb["recall_vs_resident"] >= 0.999 and sb["dist_rel_vs_resident"] <= 1e-5,
            f"(c) the streamed brute index differs from the resident one: {sb}")
    return out


def phase_ann_save_load(items: torch.Tensor, queries: torch.Tensor) -> dict:
    """(d) An ``ivfflat`` model of ``SAVE_N`` of the items, saved and
    loaded on the card, rebuilds (from its seed) an index whose neighbours
    are bitwise the saved model's."""
    from spark_rapids_ml_tpu_torch.core import persistence

    model = ApproximateNearestNeighbors().setK(NB_K).setSeed(SEED).setAlgoParams(SAVE_PARAMS).fit(items[:SAVE_N])
    _, idx = model.kneighbors(queries)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ann_model")
        t0 = time.perf_counter()
        model.write.overwrite().save(path)
        loaded = ApproximateNearestNeighborsModel.load(path)
        save_load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, idx_loaded = loaded.kneighbors(queries)
    sync()
    out = {"phase": "neighbours_save_load", "items": SAVE_N, "parquet": persistence._HAS_ARROW,
           "save_load_s": save_load_s,
           "rebuild_and_search_s": time.perf_counter() - t0,
           "bitwise_equal": bool(torch.equal(idx_loaded, idx))}
    emit(out)
    require(out["bitwise_equal"], "(d) the reloaded ivfflat model's neighbours differ from the saved model's")
    return out


def neighbour_phases(gen: torch.Generator, peaks) -> dict:
    """BASELINE configs 11, 7 and 8 through the port's neighbour
    estimators on data planted on the card, and an ``ivfflat`` save/load;
    each phase frees its data before the next. Prints the group's wall,
    which must stay within ``NB_WALL_LIMIT_S``."""
    t0 = time.perf_counter()
    items = torch.randn((NB_N, NB_D), generator=gen, device="cuda")
    queries = torch.randn((NB_Q, NB_D), generator=gen, device="cuda")
    walls = {}
    t = time.perf_counter()
    exact = phase_exact_knn(items, queries, peaks)
    walls["exact"] = time.perf_counter() - t
    t = time.perf_counter()
    c7 = phase_ann_config7(items, queries, exact["refs"]["euclidean"])
    walls["config7"] = time.perf_counter() - t
    t = time.perf_counter()
    save_load = phase_ann_save_load(items, queries)
    walls["save_load"] = time.perf_counter() - t
    del items, queries, exact
    torch.cuda.empty_cache()
    t = time.perf_counter()
    c8 = phase_ann_config8(gen)
    walls["config8"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    emit({"phases": "neighbours", "wall_s": wall, "phase_wall_s": walls})
    require(wall <= NB_WALL_LIMIT_S, f"the neighbour phases took {wall:.1f} s, over their {NB_WALL_LIMIT_S:.0f} s")
    return {"config7": c7, "config8": c8, "save_load": save_load}


# --- DBSCAN and the random forest: BASELINE configs 12 and 9 ---------------

DB_N = 100_000              # config 12: 100k x 16 float32, 20 blobs (centres N(0, 12^2)), noise 0.4
DB_D = 16
DB_BLOBS = 20
DB_EPS = 2.0
DB_MIN_SAMPLES = 8
DB_NEW = 10_000             # (a): new rows from the same blobs for transform
DB_SAVE_N = 10_000          # (d): rows of the saved DBSCAN model (~100 us a vector row)
CHAIN_N = 100_000           # (b): the chain at spacing 0.5, eps 0.6, minSamples 2
RF_N = 500_000              # config 9: 500k x 16, 8 trees, depth 6, 16 bins, 2 classes
RF_D = 16
RF_TREES = 8
RF_DEPTH = 6
RF_BINS = 16
DF_WALL_LIMIT_S = 60.0
BORDER_REL = 1e-4           # a pair this close (relative) to eps may fall either side in float32


def _ranged(module, names):
    """Wrap ``module``'s functions ``names`` in ``torch.profiler.record_function``
    ranges of the same name; returns the originals to put back."""
    from torch.profiler import record_function

    saved = {}
    for name in names:
        fn = saved[name] = getattr(module, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            with record_function(_name):
                return _fn(*args, **kwargs)

        setattr(module, name, wrapped)
    return saved


def _is_gemm(kernel: str) -> bool:
    name = kernel.lower()
    return any(t in name for t in ("gemm", "cutlass", "xmma", "sm90_", "sm80_"))


def _range_split(fit, module, names) -> dict:
    """One ``fit()`` under the profiler with ``module.names`` in ranges:
    each kernel's device ms is charged to the innermost range whose span
    on the device's timeline holds its start (GEMM kernels apart), with
    each range's count; the window, the busy device time (kernels only),
    the idle share, the kernels launched, and the seconds the profiler's
    bookkeeping took after the window."""
    from bisect import bisect_right

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    saved = _ranged(module, names)
    try:
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fit()
            sync()
            window_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)
    t_post = time.perf_counter()
    spans = {name: [] for name in names}
    kernels = []
    # The raw events: building the profiler's FunctionEvent tree for ~10^5
    # events would take longer than the fit.
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != DeviceType.CUDA:
            continue
        start, ns = evt.start_ns(), evt.duration_ns()
        if evt.name() in spans:
            spans[evt.name()].append((start, start + ns))
        elif not _is_annotation(evt):
            kernels.append((start, ns / 1e6, evt.name()))
    starts = {name: sorted(v) for name, v in spans.items()}
    keys = {name: [a for a, _ in v] for name, v in starts.items()}
    by_range = {name: {"ms": 0.0, "gemm_ms": 0.0, "count": len(v)} for name, v in spans.items()}
    busy = gemm = 0.0
    for start, ms, kname in kernels:
        busy += ms
        gemm += ms if _is_gemm(kname) else 0.0
        owner, width = None, None
        for name in names:
            i = bisect_right(keys[name], start) - 1
            if i >= 0:
                a, b = starts[name][i]
                if start <= b and (width is None or b - a < width):
                    owner, width = name, b - a
        if owner is not None:
            by_range[owner]["ms"] += ms
            by_range[owner]["gemm_ms"] += ms if _is_gemm(kname) else 0.0
    return {"window_ms": window_ms, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / window_ms,
            "kernel_launches": len(kernels), "gemm_ms": gemm, "ranges": by_range,
            "profiler_post_s": time.perf_counter() - t_post}


def dbscan_blobs(n: int, centres: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Rows of the planted blobs, as the reference's config 12 draws them:
    a uniform blob per row and N(0, 0.4^2) noise, float32 on the card."""
    assign = torch.randint(0, centres.shape[0], (n,), generator=gen, device=centres.device)
    return centres[assign] + 0.4 * torch.randn((n, centres.shape[1]), generator=gen, device=centres.device)


def _borderline(x64: torch.Tensor, rows, items: torch.Tensor, eps: float):
    """For each row, one item whose float64 distance lies within
    ``BORDER_REL`` of eps (the pair float32 may put either side), or None."""
    named = []
    for i in rows:
        d = torch.sqrt(((items - x64[i]) ** 2).sum(dim=1))
        near = torch.nonzero((d - eps).abs() <= BORDER_REL * eps)[:, 0]
        named.append(None if near.numel() == 0 else (int(i), int(near[0]), float(d[near[0]])))
    return named


def _differences_are_borderline(what: str, got: np.ndarray, want: np.ndarray, x64, items, eps) -> dict:
    """Equal, or each differing row names a pair at eps (float64)."""
    rows = np.flatnonzero(got != want)
    pairs = _borderline(x64, rows[:50], items, eps)
    out = {"differing_rows": int(rows.size), "named_pairs": [p for p in pairs if p is not None][:5]}
    require(rows.size <= 50 and all(p is not None for p in pairs),
            f"(a) {what}: {rows.size} rows differ from the float64 fit, not all at eps: {pairs[:5]}")
    return out


def phase_dbscan_config12(gen: torch.Generator, peaks) -> dict:
    """(a) BASELINE config 12: ``DBSCAN().setEps(2.0).setMinSamples(8)`` on
    100,000 x 16 float32 CUDA rows of 20 planted blobs; wall (median of
    3), sweeps, a profile split (distance GEMMs, the adjacency epilogue,
    the label passes) beside the GEMM bound (2·n²·d a sweep at the fp32
    peak); held to the float64 fit of the same rows, and 10,000 new rows
    transformed by both."""
    from spark_rapids_ml_tpu_torch.ops import dbscan as ops_dbscan

    dev = gen.device
    centres = torch.randn((DB_BLOBS, DB_D), generator=gen, device=dev) * 12.0
    x = dbscan_blobs(DB_N, centres, gen)
    x_new = dbscan_blobs(DB_NEW, centres, gen)
    est = DBSCAN().setEps(DB_EPS).setMinSamples(DB_MIN_SAMPLES)
    model = est.fit(x)
    wall = wall_s(lambda: est.fit(x))
    split = _range_split(lambda: est.fit(x), ops_dbscan, ("_eps_sweep", "_compress_labels"))
    eps_r, label_r = split["ranges"]["_eps_sweep"], split["ranges"]["_compress_labels"]
    split["split_ms"] = {"distance_gemm": eps_r["gemm_ms"], "adjacency_epilogue": eps_r["ms"] - eps_r["gemm_ms"],
                         "label_passes": label_r["ms"],
                         "rest": split["device_busy_ms"] - eps_r["ms"] - label_r["ms"]}
    sweeps = label_r["count"]  # one pointer-jumping pass per propagation round
    eps_sweeps = eps_r["count"]  # the counts, the propagation rounds, the border attachment
    del split["ranges"]
    _, _, fp32, _ = peaks
    gemm_bound_sweep_ms = 2.0 * DB_N * DB_N * DB_D / fp32 * 1e3

    x64 = x.double()
    t0 = time.perf_counter()
    model64 = DBSCAN().setEps(DB_EPS).setMinSamples(DB_MIN_SAMPLES).fit(x64)
    f64_s = time.perf_counter() - t0
    clusters = int(model.labels_.max()) + 1
    out = {"phase": "dbscan_config12", "what": "DBSCAN().setEps(2.0).setMinSamples(8), 100,000 x 16 f32 CUDA",
           "fit_wall_s": wall, "rows_per_s": DB_N / wall, "propagation_sweeps": sweeps,
           "eps_sweeps": eps_sweeps, "gemm_bound_ms_per_sweep": gemm_bound_sweep_ms,
           "gemm_bound_ms": eps_sweeps * gemm_bound_sweep_ms, "profile": split,
           "clusters": clusters, "noise_rows": int((model.labels_ < 0).sum()),
           "core_rows": int(model.core_mask_.sum()), "f64_fit_s": f64_s}
    out["vs_f64_core"] = _differences_are_borderline("core mask", model.core_mask_, model64.core_mask_, x64, x64,
                                                     DB_EPS)
    out["vs_f64_labels"] = _differences_are_borderline("labels", model.labels_, model64.labels_, x64, x64, DB_EPS)
    new32 = model.transform(x_new)
    new64 = model64.transform(x_new.double())
    cores64 = x64[torch.from_numpy(model64.core_sample_indices_).to(dev)]
    out["transform_new"] = _differences_are_borderline("transform", new32, new64, x_new.double(), cores64, DB_EPS)
    out["transform_new"]["noise_rows"] = int((new32 < 0).sum())
    out["transform_wall_s"] = wall_s(lambda: model.transform(x_new))
    emit(out)
    require(clusters == DB_BLOBS, f"(a) {clusters} clusters, not the {DB_BLOBS} planted blobs")
    return out


def phase_dbscan_chain(gen: torch.Generator) -> dict:
    """(b) The 100,000-point chain (spacing 0.5, eps 0.6, minSamples 2)
    through ``ops.dbscan.dbscan_labels(..., return_sweeps=True)`` in
    float64: one cluster of core points within 4 sweeps. The float32 chain
    is recorded, not required: at coordinate 50,000 ‖q‖² is 2.5e9, whose
    float32 spacing (256) swamps eps² = 0.36."""
    from spark_rapids_ml_tpu_torch.ops import dbscan as ops_dbscan

    out = {"phase": "dbscan_chain", "n": CHAIN_N}
    for dtype in (torch.float64, torch.float32):
        t = torch.arange(CHAIN_N, device=gen.device, dtype=dtype) * 0.5
        chain = torch.stack([t, torch.zeros_like(t)], dim=1)
        sync()
        t0 = time.perf_counter()
        labels, core, sweeps = ops_dbscan.dbscan_labels(chain, 0.6, 2, return_sweeps=True)
        sync()
        lab = labels.cpu().numpy()
        out[str(dtype).split(".")[-1]] = {
            "wall_s": time.perf_counter() - t0, "sweeps": sweeps, "core_rows": int(core.sum()),
            "clusters": int(np.unique(lab[lab >= 0]).size), "noise_rows": int((lab < 0).sum())}
    emit(out)
    f64 = out["float64"]
    require(f64["clusters"] == 1 and f64["core_rows"] == CHAIN_N and f64["noise_rows"] == 0,
            f"(b) the float64 chain is not one cluster of core points: {f64}")
    require(f64["sweeps"] <= 4, f"(b) the float64 chain took {f64['sweeps']} sweeps, over 4")
    return out


def forest_rows(gen: torch.Generator):
    """Config 9's rows as the reference's benchmark draws them: x ~ N(0, 1)
    (500,000 x 16 float32), w ~ N(0, 1), margin x·w + 0.3·noise."""
    dev = gen.device
    x = torch.randn((RF_N, RF_D), generator=gen, device=dev)
    w = torch.randn(RF_D, generator=gen, device=dev)
    return x, x @ w + 0.3 * torch.randn(RF_N, generator=gen, device=dev)


def _f64_hist_fit(x, row_stats, impurity: str, classification: bool):
    """The estimator's fit from the same draws (its generator, seeded as
    it seeds it), with histograms summed in float64 and rounded to float32
    before the split search."""
    from spark_rapids_ml_tpu_torch.models import random_forest as rf
    from spark_rapids_ml_tpu_torch.ops import trees as ops_trees

    gen = rf._forest_draws(SEED, x.device)
    w = ops_trees.sample_weights(gen, RF_TREES, RF_N, 1.0, True)
    m = rf.resolve_feature_subset("auto", RF_D, RF_TREES, classification)
    return ops_trees.fit_forest_fused(x, row_stats, w, generator=gen, max_depth=RF_DEPTH, n_bins=RF_BINS,
                                      impurity=impurity, feat_subset=m, exact_counts=classification,
                                      hist_precision="float64")


def phase_forest_config9(x: torch.Tensor, margin: torch.Tensor, peaks) -> dict:
    """(c) BASELINE config 9: ``RandomForestClassifier().setNumTrees(8)
    .setMaxDepth(6).setMaxBins(16).setNumClasses(2).setSeed(0)`` on the
    500,000 x 16 float32 CUDA pair; wall (median of 3), kernel launches, a
    profile split (histogram GEMMs, one-hot builds, split search, routing)
    beside the FLOP bound Σₗ 2·S·T·n·2ˡ·d·B at the fp32 peak; the trees
    bitwise the float64-histogram fit's."""
    from spark_rapids_ml_tpu_torch.ops import trees as ops_trees

    y = (margin > 0).to(torch.float32)
    est = (RandomForestClassifier().setNumTrees(RF_TREES).setMaxDepth(RF_DEPTH).setMaxBins(RF_BINS)
           .setNumClasses(2).setSeed(SEED))
    model = est.fit((x, y))
    wall = wall_s(lambda: est.fit((x, y)))
    split = _range_split(lambda: est.fit((x, y)), ops_trees,
                         ("_level_histogram", "_node_totals", "split_level", "grow_forest",
                          "quantize_features", "bin_features"))
    r = split.pop("ranges")
    hist_ms = r["_level_histogram"]["ms"] + r["_node_totals"]["ms"]
    hist_gemm = r["_level_histogram"]["gemm_ms"] + r["_node_totals"]["gemm_ms"]
    split["split_ms"] = {"histogram_gemm": hist_gemm, "one_hot_builds": hist_ms - hist_gemm,
                         "split_search": r["split_level"]["ms"], "routing_and_node_writes": r["grow_forest"]["ms"],
                         "quantize_and_bin": r["quantize_features"]["ms"] + r["bin_features"]["ms"]}
    _, _, fp32, _ = peaks
    flop = sum(2.0 * 2 * RF_TREES * RF_N * 2 ** level * RF_D * RF_BINS for level in range(RF_DEPTH))
    rs = torch.stack([1.0 - y, y], dim=1)
    forest64 = _f64_hist_fit(x, rs, "gini", True)
    differ = [f for f in forest64._fields if not torch.equal(getattr(model._forest, f), getattr(forest64, f))]
    probs = model.predictProbability(x)
    out = {"phase": "forest_config9", "what": "RandomForestClassifier 8 trees, depth 6, 16 bins, 500,000 x 16 f32",
           "fit_wall_s": wall, "rows_per_s": RF_N / wall, "profile": split, "flop": flop,
           "flop_bound_ms": flop / fp32 * 1e3, "fields_differing_from_f64_hist": differ,
           "split_nodes": int((model._forest.feature >= 0).sum()),
           "train_accuracy": float((torch.argmax(probs, dim=1) == y.long()).float().mean()),
           "max_prob_sum_err": float((probs.sum(dim=1) - 1.0).abs().max()),
           "predict_wall_s": wall_s(lambda: model.predictProbability(x))}
    emit(out)
    require(not differ, f"(c) the trees differ from the float64-histogram fit in {differ}")
    require(out["max_prob_sum_err"] <= 1e-5, f"(c) probabilities sum to 1 within {out['max_prob_sum_err']:.2e}")
    return {"model": model, **out}


def phase_forest_regressor_and_saves(x: torch.Tensor, margin: torch.Tensor, clf, gen: torch.Generator) -> dict:
    """(d) ``RandomForestRegressor`` at config 9's shape (y = x·w + 0.3·noise)
    against its float64-histogram fit: RMSE within 1 %, split nodes that
    differ counted. Save and load config 9's classifier (predictions
    bitwise) and a DBSCAN model of 10,000 rows."""
    from spark_rapids_ml_tpu_torch.ops import trees as ops_trees

    est = RandomForestRegressor().setNumTrees(RF_TREES).setMaxDepth(RF_DEPTH).setMaxBins(RF_BINS).setSeed(SEED)
    model = est.fit((x, margin))
    wall = wall_s(lambda: est.fit((x, margin)))
    y_mean = float(torch.mean(margin))
    yc = margin - y_mean
    forest64 = _f64_hist_fit(x, torch.stack([torch.ones_like(yc), yc, yc * yc], dim=1), "variance", False)
    forest64 = forest64._replace(leaf_value=forest64.leaf_value + y_mean)
    pred64 = ops_trees.forest_predict_reg(x, forest64, RF_DEPTH)
    rmse = float(torch.sqrt(torch.mean((model.predict(x) - margin) ** 2)))
    rmse64 = float(torch.sqrt(torch.mean((pred64 - margin) ** 2)))
    out = {"phase": "forest_regressor_and_saves", "fit_wall_s": wall, "rows_per_s": RF_N / wall,
           "rmse": rmse, "rmse_f64_hist": rmse64, "rmse_rel_diff": abs(rmse - rmse64) / rmse64,
           "split_nodes": int((model._forest.feature >= 0).sum()),
           "split_nodes_differing": int((model._forest.feature != forest64.feature).sum())}
    probs = clf.predictProbability(x)
    dev = gen.device
    centres = torch.randn((DB_BLOBS, DB_D), generator=gen, device=dev) * 12.0
    xs = dbscan_blobs(DB_SAVE_N, centres, gen)
    db = DBSCAN().setEps(DB_EPS).setMinSamples(DB_MIN_SAMPLES).fit(xs)
    q = dbscan_blobs(1_000, centres, gen)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        clf.write.overwrite().save(os.path.join(tmp, "rfc"))
        loaded = RandomForestClassificationModel.load(os.path.join(tmp, "rfc"))
        out["forest_save_load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        db.write.overwrite().save(os.path.join(tmp, "dbscan"))
        db_loaded = DBSCANModel.load(os.path.join(tmp, "dbscan"))
        out["dbscan_save_load_s"] = time.perf_counter() - t0
    out["forest_bitwise"] = bool(torch.equal(loaded.predictProbability(x), probs))
    out["dbscan_equal"] = bool(np.array_equal(db_loaded.labels_, db.labels_)
                               and np.array_equal(db_loaded.core_mask_, db.core_mask_)
                               and np.array_equal(db_loaded.fitted, db.fitted)
                               and np.array_equal(db_loaded.transform(q), db.transform(q)))
    emit(out)
    require(out["rmse_rel_diff"] <= 0.01, f"(d) RMSE {rmse} vs {rmse64} from the float64-histogram fit, over 1 %")
    require(out["forest_bitwise"], "(d) the reloaded classifier's predictions differ")
    require(out["dbscan_equal"], "(d) the reloaded DBSCAN model differs")
    return out


def dbscan_forest_phases(gen: torch.Generator, peaks) -> dict:
    """BASELINE configs 12 and 9 through the port's DBSCAN and random
    forest estimators on data drawn on the card, which launch none of
    K1-K4. Prints the group's wall, which must stay within
    ``DF_WALL_LIMIT_S``."""
    t0 = time.perf_counter()
    _reset_kernel_launches()
    walls = {}
    t = time.perf_counter()
    c12 = phase_dbscan_config12(gen, peaks)
    walls["config12"] = time.perf_counter() - t
    t = time.perf_counter()
    chain = phase_dbscan_chain(gen)
    walls["chain"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    x, margin = forest_rows(gen)
    t = time.perf_counter()
    c9 = phase_forest_config9(x, margin, peaks)
    walls["config9"] = time.perf_counter() - t
    t = time.perf_counter()
    reg = phase_forest_regressor_and_saves(x, margin, c9.pop("model"), gen)
    walls["regressor_and_saves"] = time.perf_counter() - t
    del x, margin
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    emit({"phases": "dbscan_forest", "wall_s": wall, "phase_wall_s": walls,
          "k1_k4_launches": _kernel_launch_total()})
    require(_kernel_launch_total() == 0, "the DBSCAN and forest phases launched a kernel of K1-K4")
    require(wall <= DF_WALL_LIMIT_S, f"the DBSCAN and forest phases took {wall:.1f} s, over their {DF_WALL_LIMIT_S:.0f} s")
    return {"config12": c12, "chain": chain, "config9": c9, "regressor": reg}


# --- Composition: pipelines, tuning, fusion (BASELINE configs 3 and 10) -----

CP_PCA_K = 8                # (a): PCA(8) -> KMeans(100) over config 3's 20M x 16 blobs
CP_TUNE_K = 16              # (b): PCA(16, pallas) -> LogisticRegression over config 10's 11M x 28
CP_REGS = (0.001, 0.01, 0.1)
CP_FOLDS = 3
CP_REQUEST = 32             # (d): rows of one small request
CP_REQUESTS = 200           # (d): requests timed each way
CP_CHECK_ROWS = 1_000_000   # (e): rows each reloaded model predicts
CP_WALL_LIMIT_S = 60.0


@contextlib.contextmanager
def fitted_models(klass):
    """Every model ``klass.fit`` returns while the block runs, in order:
    the validators' per-fold and refit models, kept for the checks."""
    log = []
    own = "fit" in vars(klass)
    orig = klass.fit

    def fit(self, dataset):
        model = orig(self, dataset)
        log.append(model)
        return model

    klass.fit = fit
    try:
        yield log
    finally:
        if own:
            klass.fit = orig
        else:
            del klass.fit


@contextlib.contextmanager
def fusion_off():
    os.environ["TPUML_PIPELINE_FUSION"] = "off"
    try:
        yield
    finally:
        del os.environ["TPUML_PIPELINE_FUSION"]


def copy_counter():
    """A dispatch mode that counts the bytes aten's copies move between
    the host and a device while it is active (``_to_copy``, ``copy_``,
    ``_local_scalar_dense``: every ``.to``, ``.cpu()``, ``.item()``). The
    profiler's trace proved no count: with the card's events alone it lost
    a third of the copies."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class CopyCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = {"h2d_bytes": 0, "d2h_bytes": 0, "h2d_copies": 0, "d2h_copies": 0}

        def _note(self, src: torch.device, dst: torch.device, nbytes: int) -> None:
            if (src.type == "cpu") == (dst.type == "cpu"):
                return
            key = "h2d" if src.type == "cpu" else "d2h"
            self.counts[f"{key}_bytes"] += int(nbytes)
            self.counts[f"{key}_copies"] += 1

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten._to_copy.default:
                self._note(args[0].device, out.device, out.numel() * out.element_size())
            elif func is aten.copy_.default:
                self._note(args[1].device, args[0].device, args[0].numel() * args[0].element_size())
            elif func is aten._local_scalar_dense.default:
                self._note(args[0].device, torch.device("cpu"), args[0].element_size())
            return out

    return CopyCounter()


def _serving_bytes() -> tuple:
    return counter_value("serving.h2d.bytes"), counter_value("serving.d2h.bytes")


def _labels_pca_kmeans_f64(x: torch.Tensor, pc64: torch.Tensor, c64: torch.Tensor):
    """Labels of a float64 projection and assignment, and each row's
    float64 gap between its two nearest centers beside its band width
    1e-6·(‖p‖² + max‖c‖²)."""
    labels, in_band = [], []
    c2max = float((c64 * c64).sum(dim=1).max())
    for i in range(0, x.shape[0], KM_BLOCK):
        p = x[i:i + KM_BLOCK].double() @ pc64
        d2 = (p * p).sum(dim=1, keepdim=True) - 2.0 * p @ c64.T + (c64 * c64).sum(dim=1)
        two = torch.topk(d2, 2, dim=1, largest=False)
        labels.append(two.indices[:, 0])
        in_band.append(two.values[:, 1] - two.values[:, 0] <= 1e-6 * ((p * p).sum(dim=1) + c2max))
    return torch.cat(labels), torch.cat(in_band)


def phase_composition_config3(gen: torch.Generator) -> dict:
    """(a) ``Pipeline([PCA().setK(8), KMeans().setK(100).setSeed(0)])``
    fitted on config 3's 20M x 16 float32 blobs on the card; the fused
    transform against the staged loop (bitwise) and a float64 projection
    and assignment with the same components and centers (equal off the
    named margin band); walls of fit, fused and staged transform."""
    x, _ = planted_blobs(KM_N, KM_D, KM_K, gen)
    pipe = Pipeline(stages=[PCA().setK(CP_PCA_K), KMeans().setK(KM_K).setSeed(SEED)])
    kk.reset_launches()
    model = pipe.fit(x)
    launches = dict(kk.launches)
    fused0 = counter_value("pipeline.fusion.fused")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fused = model.transform(x)
    fused_count = counter_value("pipeline.fusion.fused") - fused0
    with fusion_off():
        staged = model.transform(x)
    pc64 = torch.from_numpy(model.stages[0].pc).to(x.device)
    c64 = torch.from_numpy(model.stages[1].clusterCenters()).to(x.device)
    labels64, in_band = _labels_pca_kmeans_f64(x, pc64, c64)
    off = fused != labels64
    walls = {
        "fit": wall_s(lambda: pipe.fit(x)),
        "fused_transform": wall_s(lambda: model.transform(x)),
    }
    with fusion_off():
        walls["staged_transform"] = wall_s(lambda: model.transform(x))
    out = {
        "phase": "composition_config3", "x": [KM_N, KM_D, "float32"], "stages": "PCA(k=8) -> KMeans(k=100)",
        "kernel": "assign_stats_packed (K3)" if launches["assign_stats_packed"] else "assign_stats_fused (K2)",
        "launches": launches, "num_iter": model.stages[1].numIter, "fused_counter_delta": fused_count,
        "fused_equals_staged": bool(torch.equal(fused, staged)),
        "vs_f64_mismatches": int(off.sum()), "vs_f64_mismatches_outside_band": int((off & ~in_band).sum()),
        "band_rows": int(in_band.sum()),
        "band": "float64 gap between the two nearest centers <= 1e-6 (|p|^2 + max |c|^2)",
        "wall_s": walls, "timing": "median of 3",
    }
    emit(out)
    require(launches["assign_stats_fused"] + launches["assign_stats_packed"] >= 1,
            "(a) the pipeline's KMeans stage launched neither K2 nor K3")
    require(fused_count == 1, "(a) the plain-tensor transform did not fuse")
    require(out["fused_equals_staged"], "(a) fused labels differ from the staged loop's")
    require(out["vs_f64_mismatches_outside_band"] == 0,
            "(a) fused labels differ from the float64 assignment off the margin band")
    return {"out": out, "model": model, "x": x}


def phase_composition_config10(x: torch.Tensor, y: torch.Tensor) -> dict:
    """(b) ``CrossValidator`` over ``Pipeline([PCA().setK(16)
    .setCovarianceBackend("pallas"), LogisticRegression()...])`` with a
    regParam grid of 3 and 3 folds on config 10's 11M x 28 float32 pair on
    the card: device folds, no host copy of x (aten's copies, counted),
    K1 launches, every avgMetrics entry against a float64 re-evaluation
    of its fold models, bestModel against a fresh fit of the best map;
    (c) ``TrainValidationSplit`` over the logistic family with the AUC,
    each metric against the host route in float64."""
    from spark_rapids_ml_tpu_torch import evaluation

    n = int(x.shape[0])
    pca = PCA().setK(CP_TUNE_K).setCovarianceBackend("pallas")
    lr = LogisticRegression().setMaxIter(20).setTol(0.0)
    pipe = Pipeline(stages=[pca, lr])
    grid = ParamGridBuilder().addGrid(lr.regParam, list(CP_REGS)).build()
    cv = (CrossValidator().setEstimator(pipe).setEstimatorParamMaps(grid)
          .setEvaluator(MulticlassClassificationEvaluator().setMetricName("accuracy"))
          .setNumFolds(CP_FOLDS).setSeed(SEED))
    folds0 = counter_value("tuning.device_folds")
    _reset_kernel_launches()
    with fitted_models(Pipeline) as fits, copy_counter() as copies:
        cvm = cv.fit((x, y))
        sync()
    k1_launches = k1.launches
    folds_used = counter_value("tuning.device_folds") - folds0
    t0 = time.perf_counter()
    cvm_timed = cv.fit((x, y))
    sync()
    cv_wall = time.perf_counter() - t0

    # float64 re-evaluation of each fold model on its validation rows.
    perm = np.random.default_rng(SEED).permutation(n)
    folds = np.array_split(perm, CP_FOLDS)
    y64 = y.double()
    metrics64 = np.zeros((len(grid), CP_FOLDS))
    for fold_i, val_idx in enumerate(folds):
        idx = torch.from_numpy(np.sort(val_idx)).to(x.device)
        xv, yv = x.index_select(0, idx), y64.index_select(0, idx)
        for map_i in range(len(grid)):
            m = fits[fold_i * len(grid) + map_i]
            pc64 = torch.from_numpy(m.stages[0].pc).to(x.device)
            w64 = torch.from_numpy(m.stages[1].weights).to(x.device)
            b64 = torch.from_numpy(m.stages[1].intercepts).to(x.device)
            hits = 0.0
            for i in range(0, xv.shape[0], F64_CHUNK):
                z = (xv[i:i + F64_CHUNK].double() @ pc64) @ w64[:, 0] + b64[0]
                hits += float(((z > 0).double() == yv[i:i + F64_CHUNK]).sum())
            metrics64[map_i, fold_i] = hits / xv.shape[0]
        del xv, yv
    avg64 = metrics64.mean(axis=1)
    best = cvm.bestIndex
    fresh = pipe.copy(grid[best]).fit((x, y))
    same_best = all(
        np.array_equal(a, b) for a, b in (
            (cvm.bestModel.stages[0].pc, fresh.stages[0].pc),
            (cvm_timed.bestModel.stages[0].pc, fresh.stages[0].pc),
            (cvm.bestModel.stages[1].weights, fresh.stages[1].weights),
            (cvm_timed.bestModel.stages[1].weights, fresh.stages[1].weights),
            (cvm.bestModel.stages[1].intercepts, fresh.stages[1].intercepts),
        )
    )
    out_b = {
        "phase": "composition_config10_cv", "x": [n, int(x.shape[1]), "float32"],
        "estimator": "Pipeline(PCA(k=16, pallas) -> LogisticRegression(maxIter 20, tol 0))",
        "grid_regParam": list(CP_REGS), "folds": CP_FOLDS, "fits": len(fits),
        "avg_metrics": cvm.avgMetrics, "avg_metrics_f64": avg64.tolist(),
        "avg_vs_f64_max_abs": float(np.abs(np.asarray(cvm.avgMetrics) - avg64).max()),
        "avg_metrics_timed_run": cvm_timed.avgMetrics, "best_index": best,
        "copies_counted_by": "a torch dispatch mode over aten's copies during the first fit",
        "k1_launches": k1_launches, "device_folds": folds_used, "copies": copies.counts,
        "x_bytes": int(x.numel() * x.element_size()), "fold_index_bytes": n * 8 * CP_FOLDS,
        "best_equals_fresh_fit": same_best, "fit_wall_s": cv_wall, "timing": "one run, unprofiled",
    }
    emit(out_b)
    require(folds_used == 1, "(b) the validator did not prepare device folds")
    require(k1_launches == len(grid) * CP_FOLDS + 1, f"(b) K1 launched {k1_launches} times, not 10")
    require(copies.counts["h2d_bytes"] >= out_b["fold_index_bytes"], "(b) the copy count missed the fold indices")
    require(copies.counts["d2h_bytes"] < out_b["x_bytes"] // 100,
            "(b) the tuning fit copied x (or a fold of it) to the host")
    require(out_b["avg_vs_f64_max_abs"] <= 1e-4, "(b) avgMetrics differ from the float64 re-evaluation by > 1e-4")
    require(cvm_timed.avgMetrics == cvm.avgMetrics and cvm_timed.bestIndex == best, "(b) a second fit differs")
    require(same_best, "(b) bestModel differs from Pipeline.copy(best map).fit(full pair)")

    # (c) TrainValidationSplit over the logistic family, AUC.
    lr_c = LogisticRegression().setMaxIter(20).setTol(0.0)
    grid_c = ParamGridBuilder().addGrid(lr_c.regParam, list(CP_REGS)).build()
    tvs = (TrainValidationSplit().setEstimator(lr_c).setEstimatorParamMaps(grid_c)
           .setEvaluator(BinaryClassificationEvaluator()).setTrainRatio(0.75).setSeed(SEED))
    with fitted_models(LogisticRegression) as tvs_fits:
        t0 = time.perf_counter()
        tvm = tvs.fit((x, y))
        sync()
        tvs_wall = time.perf_counter() - t0
    n_train = int(round(n * 0.75))
    val = torch.from_numpy(np.sort(perm[n_train:])).to(x.device)
    xv, yv = x.index_select(0, val), y.index_select(0, val).cpu().numpy().astype(np.float64)
    threshold = evaluation._DEVICE_THRESHOLD
    evaluation._DEVICE_THRESHOLD = float("inf")  # the host route, whatever the size
    try:
        host = [BinaryClassificationEvaluator().evaluate(
            (yv, m.predictProbability(xv)[:, 1].cpu().numpy().astype(np.float64))) for m in tvs_fits[:len(grid_c)]]
    finally:
        evaluation._DEVICE_THRESHOLD = threshold
    del xv
    out_c = {
        "phase": "composition_config10_tvs", "estimator": "LogisticRegression(maxIter 20, tol 0)",
        "evaluator": "areaUnderROC", "train_ratio": 0.75, "validation_metrics": tvm.validationMetrics,
        "host_f64": host, "vs_host_max_abs": float(np.abs(np.asarray(tvm.validationMetrics) - host).max()),
        "best_index": tvm.bestIndex, "fit_wall_s": tvs_wall, "fits": len(tvs_fits),
    }
    emit(out_c)
    require(len(tvs_fits) == len(grid_c) + 1, "(c) the split did not fit each map and refit the best")
    require(out_c["vs_host_max_abs"] <= 1e-6, "(c) validationMetrics differ from the host route by > 1e-6")
    return {"b": out_b, "c": out_c, "cvm": cvm}


def phase_composition_host(x: torch.Tensor, model) -> dict:
    """(d) config 10's 11M x 28 float32 host array through (b)'s bestModel:
    fused against staged, bitwise, with the walls and the serving copy
    bytes of each; then a 32-row request, median of 200 calls each way."""
    host = x.cpu().numpy()

    def run(fused: bool):
        h0, d0 = _serving_bytes()
        t0 = time.perf_counter()
        if fused:
            out = model.transform(host)
        else:
            with fusion_off():
                out = model.transform(host)
        wall = time.perf_counter() - t0
        h1, d1 = _serving_bytes()
        return out, {"wall_s": wall, "h2d_bytes": h1 - h0, "d2h_bytes": d1 - d0}

    fused0 = counter_value("pipeline.fusion.fused")
    out_f, fused = run(True)
    out_s, staged = run(False)
    fused_count = counter_value("pipeline.fusion.fused") - fused0
    out_f2, fused2 = run(True)
    out_s2, staged2 = run(False)
    small = host[:CP_REQUEST]

    def per_call(fused_route: bool) -> float:
        times = []
        for _ in range(CP_REQUESTS):
            t0 = time.perf_counter()
            if fused_route:
                model.transform(small)
            else:
                with fusion_off():
                    model.transform(small)
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    small_ms = {"fused": per_call(True), "staged": per_call(False)}
    n, d, k = host.shape[0], host.shape[1], CP_TUNE_K
    predicted = {
        "fused": {"h2d_bytes": n * d * 8, "d2h_bytes": n * 4},
        "staged": {"h2d_bytes": n * d * 8 + n * k * 8, "d2h_bytes": n * k * 8 + n * (4 + 8 * 2 + 8 * 2)},
    }
    out = {
        "phase": "composition_host_input", "x": [n, d, str(host.dtype)], "fused": fused, "staged": staged,
        "second_run": {"fused": fused2, "staged": staged2}, "bytes_by_construction": predicted,
        "fused_equals_staged": bool(np.array_equal(out_f, out_s) and np.array_equal(out_f2, out_s2)),
        "fused_counter_delta": fused_count, "request_rows": CP_REQUEST, "requests": CP_REQUESTS,
        "request_ms_median": small_ms, "timing": "host clock, one call each (two runs)",
    }
    emit(out)
    require(fused_count == 1, "(d) the host-array transform did not fuse")
    require(out["fused_equals_staged"], "(d) fused and staged results differ on host input")
    for route in ("fused", "staged"):
        for key in ("h2d_bytes", "d2h_bytes"):
            require(out[route][key] == predicted[route][key], f"(d) {route} {key} is not the predicted count")
    return out


def phase_composition_saves(x3: torch.Tensor, model3, x10: torch.Tensor, cvm) -> dict:
    """(e) Save and load (a)'s PipelineModel and (b)'s CrossValidatorModel;
    the loaded models predict bitwise on 1M rows each."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model3.save(os.path.join(tmp, "pipeline"))
        cvm.save(os.path.join(tmp, "cv"))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded3 = PipelineModel.load(os.path.join(tmp, "pipeline"))
        loaded_cv = CrossValidatorModel.load(os.path.join(tmp, "cv"))
        load_s = time.perf_counter() - t0
    # A save holds float64 weights (Spark's format): the reloaded logistic
    # stage serves tensors in float64 where the float32 fit served them
    # in float32, so (b)'s model is held on host rows, which both serve
    # in float64; (a)'s stages cast their weights to the batch's dtype.
    a, b = x3[:CP_CHECK_ROWS], x10[:CP_CHECK_ROWS].cpu().numpy()
    out = {
        "phase": "composition_saves", "save_s": save_s, "load_s": load_s,
        "pipeline_equal": bool(torch.equal(loaded3.transform(a), model3.transform(a))),
        "cv_equal": bool(np.array_equal(loaded_cv.transform(b), cvm.transform(b))),
        "cv_metrics_equal": loaded_cv.avgMetrics == cvm.avgMetrics and loaded_cv.bestIndex == cvm.bestIndex,
    }
    emit(out)
    require(out["pipeline_equal"], "(e) the loaded PipelineModel predicts differently")
    require(out["cv_equal"] and out["cv_metrics_equal"], "(e) the loaded CrossValidatorModel differs")
    return out


def composition_phases(gen: torch.Generator) -> dict:
    """Pipelines, tuning and pipeline fusion at BASELINE configs 3 and 10 on
    data planted on the card: (a)-(e) of the composition slice. Prints the
    group's wall, which must stay within ``CP_WALL_LIMIT_S``."""
    t0 = time.perf_counter()
    walls = {}
    t = time.perf_counter()
    a = phase_composition_config3(gen)
    walls["a_config3"] = time.perf_counter() - t
    x10, w_true = glm_rows(gen)
    margin = (x10 - x10.mean(dim=0)) / x10.std(dim=0) @ w_true + 0.5 * torch.randn(
        GLM_N, generator=gen, device=x10.device)
    y10 = (margin > 0).float()
    del margin
    t = time.perf_counter()
    bc = phase_composition_config10(x10, y10)
    walls["bc_config10"] = time.perf_counter() - t
    t = time.perf_counter()
    d = phase_composition_host(x10, bc["cvm"].bestModel)
    walls["d_host_input"] = time.perf_counter() - t
    t = time.perf_counter()
    e = phase_composition_saves(a["x"], a["model"], x10, bc["cvm"])
    walls["e_saves"] = time.perf_counter() - t
    del a["x"], x10, y10
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    emit({"phases": "composition", "wall_s": wall, "phase_wall_s": walls})
    require(wall <= CP_WALL_LIMIT_S, f"the composition phases took {wall:.1f} s, over their {CP_WALL_LIMIT_S:.0f} s")
    return {"a": a["out"], "b": bc["b"], "c": bc["c"], "d": d, "e": e}


# Serving: the in-process runtime (ROADMAP A.8, item 17) at configs 15, 3,
# 16 and 10. Config 15's PCA is 1024 -> 16 with float32 orthonormal
# components from the seed (benchmarks/config15_serving.py); config 3's
# KMeans is k = 100 over 16 features; config 16 drives 16 closed-loop
# threads of single-row requests (benchmarks/config16_server.py).
SV_D = 1024
SV_K = 16
SV_SIZES = (1, 3, 8, 9, 100, 1_000, 4_097, 65_536)
SV_CALLS = 200              # (a): timed calls per size, each way
SV_BIG = 1_000_000          # (b): rows of the large batch
SV_BLOCK = 131_072          # (b): config 15's BLOCK
SV_THREADS = 16             # (c): config 16's closed loop
SV_REQUESTS = 150
SV_PIPE_ROWS = 32           # (d): rows of one request
SV_PIPE_REQUESTS = 200
SV_SWAP_THREADS = 4         # (e): submitting threads across the hot swap
SV_SWAP_REQUESTS = 100
SV_WALL_LIMIT_S = 60.0
EAGER_REQUEST_MS = (0.385, 0.652)  # a 32-row request on the eager fused and staged routes, before graphs (PERF.md)


def _serving_stats() -> dict:
    from spark_rapids_ml_tpu_torch.core import serving as core_serving

    return core_serving.program_cache_stats()


def _assign_f64(x: torch.Tensor, c64: torch.Tensor):
    """Labels of a float64 assignment, and whether each row lies on the
    margin band: its two nearest centers within 1e-6·(‖x‖² + max‖c‖²)."""
    x = x.double()
    d2 = (x * x).sum(dim=1, keepdim=True) - 2.0 * x @ c64.T + (c64 * c64).sum(dim=1)
    two = torch.topk(d2, 2, dim=1, largest=False)
    band = two.values[:, 1] - two.values[:, 0] <= 1e-6 * ((x * x).sum(dim=1) + (c64 * c64).sum(dim=1).max())
    return two.indices[:, 0], band


def _median_call_ms(fn, calls: int = SV_CALLS) -> float:
    """Median host wall of ``fn()`` followed by a synchronize, over ``calls``."""
    fn()
    sync()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase_serving_buckets(gen: torch.Generator) -> dict:
    """(a) The bucket ladder: config 15's PCA and config 3's KMeans on
    float32 device batches of ``SV_SIZES`` rows, twice. Captures equal the
    distinct buckets after the first pass and do not move in the second;
    each output is bitwise the eager kernel on the same padded bucket;
    projections within 1e-5 (relative to the largest) of float64, labels
    equal to a float64 assignment off the margin band. Per size, the
    median host wall of ``transform``/``predict`` (a graph replay) beside
    the eager kernel on the unpadded rows."""
    from spark_rapids_ml_tpu_torch.core.serving import bucket_rows
    from spark_rapids_ml_tpu_torch.models import kmeans as km_mod
    from spark_rapids_ml_tpu_torch.models import pca as pca_mod

    dev = gen.device
    q, _ = torch.linalg.qr(torch.randn((SV_D, SV_K), generator=gen, device=dev, dtype=torch.float64))
    pca = PCAModel("sv-pca", q.float().cpu().numpy(), np.full(SV_K, 1.0 / SV_K))
    c64 = torch.randn((KM_K, KM_D), generator=gen, device=dev, dtype=torch.float64) * KM_SCALE
    km = KMeansModel("sv-km", c64.cpu().numpy())
    n_max = max(SV_SIZES)
    idx = torch.randint(0, KM_K, (n_max,), generator=gen, device=dev)
    families = {
        "pca": (pca.transform, pca_mod._project_kernel, (pca._pc_device(torch.float32, dev),),
                {"precision": pca._serving_precision()},
                torch.randn((n_max, SV_D), generator=gen, device=dev)),
        "kmeans": (km.predict, km_mod._assign_kernel, (km._centers_on(dev, torch.float32),),
                   {"cosine": False, "precision": km._serving_precision()},
                   (c64[idx] + torch.randn((n_max, KM_D), generator=gen, device=dev, dtype=torch.float64)).float()),
    }
    pc64 = torch.from_numpy(pca.pc).to(dev)
    buckets = sorted({bucket_rows(n) for n in SV_SIZES})
    out = {"phase": "serving_buckets", "sizes": list(SV_SIZES), "buckets": buckets, "families": {}}
    for name, (call, kernel, weights, static, x) in families.items():
        s0 = _serving_stats()
        outs = [call(x[:n]) for n in SV_SIZES]
        s1 = _serving_stats()
        for n in SV_SIZES:
            call(x[:n])
        s2 = _serving_stats()
        rows = []
        for n, got in zip(SV_SIZES, outs):
            xb = x[:n]
            b = bucket_rows(n)
            xp = torch.zeros((b, xb.shape[1]), dtype=xb.dtype, device=dev)
            xp[:n] = xb
            bitwise = bool(torch.equal(got, kernel(xp, *weights, **static)[:n]))
            if name == "pca":
                ref = xb.double() @ pc64
                check = {"rel_err_vs_f64": float((got.double() - ref).abs().max() / ref.abs().max())}
            else:
                labels64, band = _assign_f64(xb, c64)
                off = got != labels64
                check = {"labels_differ": int(off.sum()), "differ_off_band": int((off & ~band).sum())}
            rows.append({
                "rows": n, "bucket": b, "bitwise_eager_at_bucket": bitwise, **check,
                "replay_call_ms": _median_call_ms(lambda: call(xb)),
                "eager_call_ms": _median_call_ms(lambda: kernel(xb, *weights, **static)),
            })
        crossover = next((r["bucket"] for r in rows if r["replay_call_ms"] >= r["eager_call_ms"]), None)
        out["families"][name] = {
            "captures_first_pass": s1["compiles"] - s0["compiles"], "captures_second_pass": s2["compiles"] - s1["compiles"],
            "hits_second_pass": s2["hits"] - s1["hits"], "per_size": rows,
            "first_bucket_where_replay_is_not_faster": crossover,
        }
    emit(out)
    for name, fam in out["families"].items():
        require(fam["captures_first_pass"] == len(buckets), f"(a) {name}: captures != distinct buckets")
        require(fam["captures_second_pass"] == 0, f"(a) {name}: the second pass captured")
        for r in fam["per_size"]:
            require(r["bitwise_eager_at_bucket"], f"(a) {name} at {r['rows']} rows: replay != eager at the bucket")
            if name == "pca":
                require(r["rel_err_vs_f64"] <= 1e-5, f"(a) pca at {r['rows']} rows: projection off float64")
            else:
                require(r["differ_off_band"] == 0, f"(a) kmeans at {r['rows']} rows: labels off float64")
    return {"out": out, "pca": pca}


def phase_serving_large(gen: torch.Generator, pca) -> dict:
    """(b) A 1,000,000 x 1,024 float32 device batch through
    ``PCAModel.transform`` (above the capture bound: eager, counted as a
    bypass) beside its bytes bound; the same rows as a host array through
    the pinned double-buffered stream in config 15's 131,072-row blocks
    (wall and H2D rate), beside a pageable ``.to(device)`` loop over the
    same blocks and the stream's stages timed alone (host staging, the
    pinned copy, the compute): the share of the wall they overlap is what
    the stream hides of their sum (the profiler's raw memcpy events lost
    copies on that machine); each block's result bitwise the same kernel
    on the block widened to float64 on the card."""
    from spark_rapids_ml_tpu_torch.models import pca as pca_mod

    dev = gen.device
    _, hbm, _, _ = peaks_for(torch.cuda.get_device_name(0))
    x = torch.randn((SV_BIG, SV_D), generator=gen, device=dev)
    b0 = counter_value("serving.cache.bypass")
    y = pca.transform(x)
    device_wall = wall_s(lambda: pca.transform(x))
    bypasses = counter_value("serving.cache.bypass") - b0
    ref = x[:65_536].double() @ torch.from_numpy(pca.pc).to(dev)
    device_rel = float((y[:65_536].double() - ref).abs().max() / ref.abs().max())
    bound_ms = (SV_BIG * SV_D * 4 + SV_BIG * SV_K * 4) / hbm * 1e3
    host = x.cpu().numpy()
    del x, y, ref
    blocks = [host[i:i + SV_BLOCK] for i in range(0, SV_BIG, SV_BLOCK)]
    nbytes = host.nbytes

    h0, d0 = _serving_bytes()
    t0 = time.perf_counter()
    outs = list(pca.transform(iter(blocks)))
    first_wall = time.perf_counter() - t0  # includes allocating the pinned buffers
    h1, d1 = _serving_bytes()
    t0 = time.perf_counter()
    for _ in pca.transform(iter(blocks)):
        pass
    pinned_wall = time.perf_counter() - t0

    def pageable():
        for blk in blocks:
            torch.from_numpy(blk).to(dev)
        sync()

    t0 = time.perf_counter()
    pageable()
    pageable_wall = time.perf_counter() - t0

    # The stream's three stages, each timed alone over the same blocks: the
    # host's copy into pinned memory (host clock), the copy to the card and
    # the widening plus projection (CUDA events). What the stream hides of
    # their sum is the overlap.
    pc64 = pca._pc_device(torch.float64, dev)
    static = {"precision": pca._serving_precision()}
    pinned = torch.empty(blocks[0].shape, dtype=torch.float32, pin_memory=True)
    x_dev = torch.empty(blocks[0].shape, dtype=torch.float32, device=dev)
    stage_s = h2d_ms = compute_ms = 0.0
    for blk in blocks:
        n = blk.shape[0]
        t0 = time.perf_counter()
        pinned[:n].copy_(torch.from_numpy(blk))
        stage_s += time.perf_counter() - t0
        start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        start.record()
        x_dev[:n].copy_(pinned[:n], non_blocking=True)
        mid.record()
        pca_mod._project_kernel(x_dev[:n].double(), pc64, **static)
        end.record()
        sync()
        h2d_ms += start.elapsed_time(mid)
        compute_ms += mid.elapsed_time(end)
    del pinned, x_dev
    serial_ms = stage_s * 1e3 + h2d_ms + compute_ms
    hidden_ms = serial_ms - pinned_wall * 1e3
    bitwise = all(
        np.array_equal(o, pca_mod._project_kernel(torch.from_numpy(blk).to(dev).double(), pc64, **static).cpu().numpy())
        for blk, o in zip(blocks, outs))
    out = {
        "phase": "serving_large", "x": [SV_BIG, SV_D, "float32"],
        "device_batch": {"wall_ms": device_wall * 1e3, "bytes_bound_ms": bound_ms, "bypass_count": bypasses,
                         "rel_err_vs_f64_first_65536": device_rel},
        "host_stream": {"block_rows": SV_BLOCK, "blocks": len(blocks), "first_wall_s": first_wall,
                        "wall_s": pinned_wall, "h2d_bytes": h1 - h0, "d2h_bytes": d1 - d0,
                        "h2d_gb_s_over_wall": nbytes / pinned_wall / 1e9,
                        "alone": {"host_staging_ms": stage_s * 1e3, "h2d_copy_ms": h2d_ms,
                                  "compute_ms": compute_ms,
                                  "pinned_h2d_gb_s": nbytes / (h2d_ms / 1e3) / 1e9},
                        "serial_sum_ms": serial_ms, "hidden_ms": hidden_ms,
                        "overlap_share_of_wall": hidden_ms / (pinned_wall * 1e3),
                        "overlap": "the stages' sum timed alone minus the stream's wall"},
        "pageable_copy_loop": {"wall_s": pageable_wall, "h2d_gb_s": nbytes / pageable_wall / 1e9},
        "stream_bitwise_kernel_on_f64_blocks": bitwise,
        "timing": "host clock; device batch median of 3 after one call",
    }
    emit(out)
    require(bypasses >= 1, "(b) the 1M-row device batch was not served eagerly above the capture bound")
    require(device_rel <= 1e-5, "(b) the device batch's projection is off float64")
    require(h1 - h0 == nbytes, "(b) the stream did not copy each host byte once")
    require(bitwise, "(b) a streamed block differs from the kernel on its float64 rows")
    return out


def _closed_loop(rt, probes: np.ndarray):
    """``SV_THREADS`` workers, one outstanding single-row request each:
    the wall, every answer, and each request's submit-to-result ms."""
    answers = np.zeros(probes.shape[:2], dtype=np.int64)
    lat = np.zeros(probes.shape[:2])

    def worker(tid: int) -> None:
        for j in range(probes.shape[1]):
            t0 = time.perf_counter()
            answers[tid, j] = rt.submit("km", probes[tid, j]).result(timeout=120)[0]
            lat[tid, j] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(probes.shape[0])]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads), "(c) a closed-loop worker did not finish")
    return wall, answers, lat


def phase_serving_config16(gen: torch.Generator) -> dict:
    """(c) Config 16 at full width: a ``ServingRuntime`` serving config 3's
    KMeans (k = 100, d = 16) to 16 closed-loop threads x 150 single-row
    requests, once with ``max_batch=1, max_delay_ms=0`` and once with
    ``max_batch=16, max_delay_ms=5``, both warmed; rows/s and their ratio,
    p50 / p99 latency (the histogram's and the exact), dispatches, mean
    batch fill. Every answer equals a float64 assignment off the band."""
    from spark_rapids_ml_tpu_torch.observability.metrics import percentile_from_histogram
    from spark_rapids_ml_tpu_torch.serving import ServingRuntime
    from spark_rapids_ml_tpu_torch.serving.batcher import _latency_hist

    dev = gen.device
    c64 = torch.randn((KM_K, KM_D), generator=gen, device=dev, dtype=torch.float64) * KM_SCALE
    model = KMeansModel("sv16", c64.cpu().numpy())
    total = SV_THREADS * SV_REQUESTS
    idx = torch.randint(0, KM_K, (total,), generator=gen, device=dev)
    rows = c64[idx] + 4.0 * torch.randn((total, KM_D), generator=gen, device=dev, dtype=torch.float64)
    labels64, band = _assign_f64(rows, c64)
    probes = rows.cpu().numpy().reshape(SV_THREADS, SV_REQUESTS, KM_D)

    def run(max_batch: int, delay_ms: float) -> dict:
        rt = ServingRuntime(max_batch=max_batch, max_delay_ms=delay_ms, queue_limit=4 * total)
        rt.register("km", model)
        rt.warm("km", buckets=[1 << p for p in range(9) if (1 << p) <= max_batch])
        d0 = counter_value("serving.batch.dispatch")
        r0 = counter_value("serving.batch.rows_total")
        h0 = _latency_hist().value()
        s0 = _serving_stats()
        wall, answers, lat = _closed_loop(rt, probes)
        dispatches = counter_value("serving.batch.dispatch") - d0
        h1 = _latency_hist().value()
        s1 = _serving_stats()
        rt.close()
        hist = {"buckets": {le: c - h0["buckets"][le] for le, c in h1["buckets"].items()},
                "count": h1["count"] - h0["count"], "sum": h1["sum"] - h0["sum"]}
        got = torch.from_numpy(answers.reshape(-1)).to(dev)
        off = got != labels64
        return {
            "max_batch": max_batch, "max_delay_ms": delay_ms, "wall_s": wall, "rows_per_s": total / wall,
            "dispatches": dispatches, "requests_per_dispatch": total / dispatches,
            "mean_batch_fill": (counter_value("serving.batch.rows_total") - r0) / dispatches / max_batch,
            "p50_ms_histogram": percentile_from_histogram(hist, 0.50),
            "p99_ms_histogram": percentile_from_histogram(hist, 0.99),
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "captures_during_run": s1["compiles"] - s0["compiles"],
            "labels_differ": int(off.sum()), "differ_off_band": int((off & ~band).sum()),
        }

    unbatched = run(1, 0.0)
    batched = run(SV_THREADS, 5.0)
    out = {"phase": "serving_config16", "model": [KM_K, KM_D], "threads": SV_THREADS, "requests": SV_REQUESTS,
           "unbatched": unbatched, "batched": batched,
           "batched_over_unbatched_rows_s": batched["rows_per_s"] / unbatched["rows_per_s"],
           "timing": "host clock, closed loop"}
    emit(out)
    require(unbatched["dispatches"] == total, "(c) max_batch=1 coalesced")
    require(batched["dispatches"] * 4 <= total, "(c) the batched run coalesced fewer than 4 requests a dispatch")
    for run_ in (unbatched, batched):
        require(run_["differ_off_band"] == 0, "(c) an answer differs from the float64 assignment")
        require(run_["captures_during_run"] == 0, "(c) a warmed run captured")
    return out


def phase_serving_pipeline(gen: torch.Generator) -> dict:
    """(d) Config 10's PCA(16) -> logistic ``PipelineModel``, fitted on the
    11M x 28 float32 pair on the card, registered as one version: 200
    requests of 32 host rows, each one graph replay of the fused chain;
    the median request latency beside the same rows through
    ``PipelineModel.transform`` and the eager routes' 0.385-0.652 ms; every
    answer bitwise ``transform`` of its rows (the same bucket)."""
    from spark_rapids_ml_tpu_torch.serving import ServingRuntime

    x10, w_true = glm_rows(gen)
    margin = (x10 - x10.mean(dim=0)) / x10.std(dim=0) @ w_true + 0.5 * torch.randn(
        GLM_N, generator=gen, device=x10.device)
    y10 = (margin > 0).float()
    del margin
    t0 = time.perf_counter()
    model = Pipeline(stages=[PCA().setK(CP_TUNE_K),
                             LogisticRegression().setRegParam(0.01).setMaxIter(20).setTol(0.0)]).fit((x10, y10))
    fit_wall = time.perf_counter() - t0
    host = x10[:SV_PIPE_ROWS * SV_PIPE_REQUESTS].cpu().numpy()
    del x10, y10
    reqs = [host[i * SV_PIPE_ROWS:(i + 1) * SV_PIPE_ROWS] for i in range(SV_PIPE_REQUESTS)]
    with ServingRuntime(max_batch=SV_PIPE_ROWS, max_delay_ms=5.0) as rt:
        s0 = _serving_stats()
        rt.register("pipe", model, warm_buckets=(SV_PIPE_ROWS,))
        s1 = _serving_stats()
        answers, lat = [], []
        for r in reqs:
            t0 = time.perf_counter()
            answers.append(rt.submit("pipe", r).result(timeout=60))
            lat.append((time.perf_counter() - t0) * 1e3)
        s2 = _serving_stats()
    direct = []
    fused0 = counter_value("pipeline.fusion.fused")
    wants = []
    for r in reqs:
        t0 = time.perf_counter()
        wants.append(model.transform(r))
        direct.append((time.perf_counter() - t0) * 1e3)
    fused = counter_value("pipeline.fusion.fused") - fused0
    s3 = _serving_stats()
    out = {
        "phase": "serving_pipeline", "x": [GLM_N, GLM_D, "float32"], "fit_rows": GLM_N, "fit_wall_s": fit_wall,
        "request_rows": SV_PIPE_ROWS, "requests": SV_PIPE_REQUESTS,
        "warm_captures": s1["compiles"] - s0["compiles"],
        "captures_while_serving": s2["compiles"] - s1["compiles"],
        "captures_in_transform": s3["compiles"] - s2["compiles"],
        "runtime_request_ms": {"median": statistics.median(lat), "p99": float(np.percentile(lat, 99))},
        "transform_request_ms": {"median": statistics.median(direct), "p99": float(np.percentile(direct, 99))},
        "eager_route_request_ms": list(EAGER_REQUEST_MS), "transform_fused_count": fused,
        "bitwise_transform": all(np.array_equal(a, w) for a, w in zip(answers, wants)),
        "timing": "host clock, one request at a time",
    }
    emit(out)
    require(out["warm_captures"] == 1, "(d) warming the fused pipeline did not capture one graph")
    require(out["captures_while_serving"] == 0 and out["captures_in_transform"] == 0,
            "(d) serving or transform captured again")
    require(fused == SV_PIPE_REQUESTS, "(d) transform did not fuse")
    require(out["bitwise_transform"], "(d) a runtime answer differs from PipelineModel.transform")
    return out


def phase_serving_lifecycle(gen: torch.Generator) -> dict:
    """(e) Lifecycle and admission on the card: a hot swap v1 -> v2 under
    ``SV_SWAP_THREADS`` submitting threads (dyadic rows and centers, so no
    batch shape can change a bit): every answer its own version's, no
    batch mixing versions (the event log); ``retire(v1)`` frees its
    weights and graphs (``memory_allocated``); a queue limit and a byte
    budget shed with ``Overloaded`` (the budget back to 0 reserved bytes
    after), an expired deadline fails with ``DeadlineExceeded``,
    ``close(drain=True)`` answers every request, and no batch degraded."""
    import gc

    from spark_rapids_ml_tpu_torch.core import serving as core_serving
    from spark_rapids_ml_tpu_torch.observability import events
    from spark_rapids_ml_tpu_torch.serving import DeadlineExceeded, Overloaded, ServingRuntime
    from spark_rapids_ml_tpu_torch.serving.signature import spec_bytes, tree_leaves

    rng = np.random.default_rng(SEED)
    m1 = KMeansModel("sv-v1", rng.integers(-64, 64, (KM_K, KM_D)) / 4.0)
    m2 = KMeansModel("sv-v2", rng.integers(-64, 64, (KM_K, KM_D)) / 4.0 + 8.0)
    total = SV_SWAP_THREADS * SV_SWAP_REQUESTS
    probes = rng.integers(-64, 64, (total, KM_D)) / 4.0
    exp = {1: m1.predict(probes), 2: m2.predict(probes)}
    degraded0 = counter_value("serving.degraded_batches")
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "events.jsonl")
        events.configure(log)
        try:
            rt = ServingRuntime(max_batch=16, max_delay_ms=2.0)
            v1 = rt.register("km", m1, alias="prod", warm_buckets=(1, 16)).version
            collected, lock = [], threading.Lock()
            started, swapped = threading.Event(), threading.Event()

            def worker(tid: int) -> None:
                local = []
                for j in range(SV_SWAP_REQUESTS):
                    i = tid * SV_SWAP_REQUESTS + j
                    fut = rt.submit("km@prod", probes[i])
                    local.append((i, fut.result(timeout=60), fut.model_version))
                    if tid == 0 and j == SV_SWAP_REQUESTS // 5:
                        started.set()
                    if tid == 0 and j == SV_SWAP_REQUESTS // 2:
                        swapped.wait(timeout=60)
                with lock:
                    collected.extend(local)

            threads = [threading.Thread(target=worker, args=(t,)) for t in range(SV_SWAP_THREADS)]
            for t in threads:
                t.start()
            require(started.wait(timeout=60), "(e) no request finished before the swap")
            v2 = rt.register("km", m2, warm_buckets=(1, 16)).version
            rt.set_alias("km", "prod", v2)
            swapped.set()
            for t in threads:
                t.join(timeout=120)
            require(not any(t.is_alive() for t in threads), "(e) a submitting thread did not finish")

            # retire(v1): its device weights and every graph that reads them.
            cached = [w for entry in (m1._centers_dev or {}).values() for w in tree_leaves(entry)]
            ptrs = {w.data_ptr() for w in cached}
            progs = [p for p in core_serving._PROGRAMS.values() if p.ptrs & ptrs]
            held = sum(t.numel() * t.element_size() for p in progs
                       for t in tree_leaves((p.static_x, p.static_out)) if isinstance(t, torch.Tensor))
            held += sum(w.numel() * w.element_size() for w in cached)
            n_graphs = len(progs)
            del cached, progs
            gc.collect()
            sync()
            before = torch.cuda.memory_allocated()
            rt.retire("km", v1)
            gc.collect()
            sync()
            freed = before - torch.cuda.memory_allocated()
            rt.close()
        finally:
            events.configure()
        recs = [json.loads(line) for line in open(log)]
    serving_recs = [r for r in recs if r["event"] == "serving"]
    admitted = {r["run_id"]: r["version"] for r in serving_recs if r["action"] == "enqueue"}
    mixed = sum(1 for r in serving_recs if r["action"] == "dispatch"
                and {admitted[rid] for rid in r["run_ids"]} != {r["version"]})
    wrong = sum(1 for i, ans, ver in collected if not np.array_equal(ans, exp[ver][i:i + 1]))
    by_version = {v: sum(1 for *_, ver in collected if ver == v) for v in (1, 2)}

    # Admission on the card: a queue limit, a byte budget, a deadline, a drain.
    sig = m2.serving_signature()
    price = 8 * KM_D * 8 + spec_bytes(sig.output_spec(8, torch.float64))
    shed = {}
    rt = ServingRuntime(queue_limit=2, start=False)
    rt.register("km", m2)
    queued = [rt.submit("km", probes[i]) for i in range(2)]
    try:
        rt.submit("km", probes[2])
    except Overloaded as exc:
        shed["queue"] = exc.reason
    rt.close(drain=True)
    drained = all(f.result(timeout=60).shape == (1,) for f in queued)
    rt = ServingRuntime(mem_budget=2 * price, start=False)
    rt.register("km", m2)
    queued = [rt.submit("km", probes[i]) for i in range(2)]
    try:
        rt.submit("km", probes[2])
    except Overloaded as exc:
        shed["memory"] = exc.reason
    rt.start()
    [f.result(timeout=60) for f in queued]
    deadline = time.monotonic() + 30.0
    while rt.snapshot()["reserved_bytes"] and time.monotonic() < deadline:
        time.sleep(0.001)
    reserved_after = rt.snapshot()["reserved_bytes"]
    rt.close()
    rt = ServingRuntime(start=False)
    rt.register("km", m2)
    late = rt.submit("km", probes[0], timeout=0.01)
    pending = [rt.submit("km", probes[i]) for i in range(1, 6)]
    time.sleep(0.05)
    rt.close(drain=True)
    try:
        late.result(timeout=60)
        expired = "answered"
    except DeadlineExceeded:
        expired = "DeadlineExceeded"
    drain_all = all(f.result(timeout=60).shape == (1,) for f in pending)
    out = {
        "phase": "serving_lifecycle", "model": [KM_K, KM_D], "threads": SV_SWAP_THREADS, "requests": total,
        "answers_by_version": by_version, "wrong_answers": wrong, "mixed_version_batches": mixed,
        "retire": {"graphs": n_graphs, "held_bytes": held, "freed_bytes": freed},
        "shed": shed, "reserved_bytes_after_budget_drain": reserved_after, "deadline": expired,
        "drain_answered_all": drained and drain_all,
        "degraded_batches": counter_value("serving.degraded_batches") - degraded0,
    }
    emit(out)
    require(len(collected) == total and wrong == 0, "(e) an answer is not its version's")
    require(by_version[1] > 0 and by_version[2] > 0, "(e) the swap did not split the stream")
    require(mixed == 0, "(e) a batch mixed versions")
    require(n_graphs >= 2 and freed >= held, "(e) retire did not free v1's weights and graphs")
    require(shed == {"queue": "queue", "memory": "memory"}, "(e) admission did not shed")
    require(reserved_after == 0, "(e) the byte budget did not return to 0")
    require(expired == "DeadlineExceeded", "(e) an expired deadline was answered")
    require(out["drain_answered_all"], "(e) close(drain=True) left a request unanswered")
    require(out["degraded_batches"] == 0, "(e) a batch degraded")
    return out


def serving_phases(gen: torch.Generator) -> dict:
    """The in-process serving runtime at configs 15, 3, 16 and 10: (a)-(e)
    of the serving slice. Prints the group's wall, which must stay within
    ``SV_WALL_LIMIT_S``."""
    t0 = time.perf_counter()
    walls = {}
    t = time.perf_counter()
    a = phase_serving_buckets(gen)
    walls["a_buckets"] = time.perf_counter() - t
    t = time.perf_counter()
    b = phase_serving_large(gen, a["pca"])
    walls["b_large"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    c = phase_serving_config16(gen)
    walls["c_config16"] = time.perf_counter() - t
    t = time.perf_counter()
    d = phase_serving_pipeline(gen)
    walls["d_pipeline"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    e = phase_serving_lifecycle(gen)
    walls["e_lifecycle"] = time.perf_counter() - t
    wall = time.perf_counter() - t0
    emit({"phases": "serving", "wall_s": wall, "phase_wall_s": walls, "program_cache": _serving_stats()})
    require(wall <= SV_WALL_LIMIT_S, f"the serving phases took {wall:.1f} s, over their {SV_WALL_LIMIT_S:.0f} s")
    return {"a": a["out"], "b": b, "c": c, "d": d, "e": e}


MS_N = 1_048_576            # (a), (c): config 5's width, 1,048,576 x 1,024 float32 rows
MS_PARTS = 4                # (a): host partitions of 262,144 rows
MS_ST_N = 2_000_000         # (b): config 5's block step, 2 host blocks of its BLOCK
MS_ST_BLOCK = 1_000_000
MS_SEED_A = SEED + 100      # (a) and (c)'s NCCL world-of-one refit draw the same rows
MS_SEED_GLM = SEED + 200    # (c) and (d)'s config 10 rows
MS_RANKS = 2
MS_RANK_TIMEOUT_S = 150
MS_WALL_LIMIT_S = 120.0
MS_F64_CHUNK = 1 << 20      # rows per chunk of the group's float64 references


def _mesh_of(shape):
    """A mesh of ``shape`` positions, every one on the one card."""
    return make_mesh(shape, devices=[torch.device("cuda", 0)] * (shape[0] * shape[1]))


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def phase_mesh_config5(gen_seed: int) -> dict:
    """(a) Config 5's width in one process: ``PCA(mesh=...).setK(16)`` on a
    1,048,576 x 1,024 float32 tensor over a (1, 1) mesh and a (4, 1) mesh of
    the one card, and the same rows as 4 host partitions through
    ``shard_rows_from_partitions`` on the (4, 1) mesh; held to the on-card
    float64 fit and to the single-device ``xla`` fit; K1 never launched and
    ``pallas`` with a mesh refused."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(gen_seed)
    x = planted(MS_N, D, gen)
    parts = list(x.cpu().numpy().reshape(MS_PARTS, MS_N // MS_PARTS, D))
    m11, m41 = _mesh_of((1, 1)), _mesh_of((4, 1))
    single = PCA().setK(K)
    k1.reset_launches()
    fits = {
        "mesh_1x1": lambda: PCA(mesh=m11).setK(K).fit(x),
        "mesh_4x1": lambda: PCA(mesh=m41).setK(K).fit(x),
        "mesh_4x1_host_parts": lambda: PCA(mesh=m41).setK(K).fit(parts),
    }
    models = {name: fit() for name, fit in fits.items()}
    launches = k1.launches
    walls = {name: wall_s(lambda f=fit: f().pc) for name, fit in fits.items()}
    model_single = single.fit(x)
    walls["single_device"] = wall_s(lambda: single.fit(x).pc)
    try:
        PCA(mesh=m11).setK(K).setCovarianceBackend("pallas").fit(x)
        pallas_refused = False
    except ValueError:
        pallas_refused = True
    model64 = PCA().setK(K).fit(x.double())
    pc64, ev64 = model64.pc, model64.explainedVariance
    out = {"phase": "mesh_config5", "x": [MS_N, D, "torch.float32"], "k": K,
           "host_parts": [MS_PARTS, MS_N // MS_PARTS, D], "k1_launches": launches,
           "pallas_with_mesh_refused": pallas_refused, "fit_wall_s_median_of_3": walls}
    for name, model in models.items():
        out[name] = {
            "pc_vs_f64_max_abs": _pc_err(model.pc, pc64),
            "ev_vs_f64_rel": _ev_rel(model.explainedVariance, ev64),
            "pc_vs_single_xla_max_abs": _pc_err(model.pc, model_single.pc),
            "ev_vs_single_xla_rel": _ev_rel(model.explainedVariance, model_single.explainedVariance),
        }
    emit(out)
    require(launches == 0, "a mesh fit launched K1")
    require(pallas_refused, "covarianceBackend='pallas' with a mesh was not refused")
    for name in models:
        got = out[name]
        require(got["pc_vs_f64_max_abs"] <= 1e-3, f"(a) {name} components differ from the f64 fit")
        require(got["ev_vs_f64_rel"] <= 1e-4, f"(a) {name} explained variance differs from the f64 fit")
        require(got["pc_vs_single_xla_max_abs"] <= 1e-5, f"(a) {name} components differ from the xla fit")
        require(got["ev_vs_single_xla_rel"] <= 1e-4, f"(a) {name} explained variance differs from the xla fit")
    return {"out": out, "pc_1x1": models["mesh_1x1"].pc, "ev_1x1": models["mesh_1x1"].explainedVariance}


def phase_mesh_stream(gen: torch.Generator, peaks) -> dict:
    """(b) Config 5's block step: ``streaming_mean_and_covariance_mesh``
    over 2,000,000 x 1,024 float32 rows as 2 host blocks of 1,000,000 rows
    on the (1, 1) mesh, one run under ``torch.profiler`` for the H2D share
    of the window; held to ``streaming_mean_and_covariance`` on the same
    blocks."""
    from torch.profiler import ProfilerActivity, profile

    x = planted(MS_ST_N, D, gen)
    blocks = [x[i:i + MS_ST_BLOCK].cpu().numpy() for i in range(0, MS_ST_N, MS_ST_BLOCK)]
    del x
    torch.cuda.empty_cache()
    m11 = _mesh_of((1, 1))
    mesh_cov = ops_covariance.streaming_mean_and_covariance_mesh
    _, cov, n = mesh_cov(iter(blocks), m11)
    wall = wall_s(lambda: mesh_cov(iter(blocks), m11))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mesh_cov(iter(blocks), m11)
        sync()
        window_ms = (time.perf_counter() - t0) * 1e3
    device_ms = _device_ms_by_kernel(prof)
    h2d_ms = _h2d_ms(prof)
    _, cov_single, _ = ops_covariance.streaming_mean_and_covariance(iter(blocks), device=m11.first_device)
    bound_ms, bound_by = gram_bound_ms(MS_ST_N, D, torch.float64, peaks)
    out = {
        "phase": "mesh_stream", "x": [MS_ST_N, D, "float32 host"], "blocks": len(blocks),
        "block_rows": MS_ST_BLOCK, "mesh": [1, 1], "rows": int(n), "wall_s_median_of_3": wall,
        "rows_per_s": MS_ST_N / wall,
        "profile": {"window_ms": window_ms, "device_busy_ms": sum(device_ms.values()),
                    "h2d_copy_ms": h2d_ms, "h2d_share_of_window": h2d_ms / window_ms},
        "f64_gram_bound_ms": bound_ms, "f64_gram_bound_by": bound_by,
        "cov_vs_single_rel": _rel_err(cov, cov_single),
    }
    emit(out)
    require(int(n) == MS_ST_N, "(b) the streamed mesh covariance lost rows")
    require(out["cov_vs_single_rel"] <= 1e-10, "(b) the streamed mesh covariance differs from the single-device scan")
    return out


def _glm_logistic_rows(seed: int):
    """Config 10's 11M x 28 float32 rows and labels, drawn on the card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x, w_true = glm_rows(gen)
    margin = (x - x.mean(dim=0)) / x.std(dim=0) @ w_true + 0.5 * torch.randn(GLM_N, generator=gen, device=x.device)
    return x, (margin > 0).float()


def _logistic_config10():
    return LogisticRegression().setRegParam(0.01).setMaxIter(20).setTol(0.0)


def mesh_rank_main(argv) -> int:
    """One rank of (c), started by :func:`phase_mesh_gang`: joins the gang
    (gloo with CUDA tensors for two ranks on the one card, NCCL for a world
    of one), fits its share through ``setDeployMode("gang")`` and writes its
    results to ``--mesh-out``."""
    args = dict(zip(argv[1::2], argv[2::2]))
    rank, world = int(args["--mesh-rank"]), int(args["--mesh-world"])
    out_dir, backend = args["--mesh-out"], args["--mesh-backend"]
    port_device.set_platform("cuda")
    port_device.use_ieee_fp32_matmul()
    gang.initialize(coordinator_address=f"127.0.0.1:{args['--mesh-port']}", backend=backend)
    reduce_s = [0.0]
    all_reduce = torch.distributed.all_reduce

    def timed_all_reduce(tensor, *a, **kw):
        t0 = time.perf_counter()
        work = all_reduce(tensor, *a, **kw)
        if tensor.is_cuda:
            sync()
        reduce_s[0] += time.perf_counter() - t0
        return work

    torch.distributed.all_reduce = timed_all_reduce
    res, walls = {}, {}
    t_rank = time.perf_counter()
    if world == 1:
        # The NCCL world of one: (a)'s rows, refit as a gang.
        gen = torch.Generator(device="cuda")
        gen.manual_seed(MS_SEED_A)
        x = planted(MS_N, D, gen)
        t0 = time.perf_counter()
        model = PCA().setDeployMode("gang").setK(K).fit(x)
        res["pc"], res["ev"] = model.pc, model.explainedVariance
        walls["pca_gang"] = time.perf_counter() - t0
    else:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + rank)
        x = planted(MS_N, D, gen)
        t0 = time.perf_counter()
        model = PCA().setDeployMode("gang").setK(K).fit(x)
        res["pc"], res["ev"] = model.pc, model.explainedVariance
        walls["pca_gang"] = time.perf_counter() - t0
        blocks = list(x.cpu().numpy().reshape(MS_PARTS, MS_N // MS_PARTS, D))
        del x, model
        torch.cuda.empty_cache()
        for merge in ("psum", "allgather"):
            t0 = time.perf_counter()
            mean, cov, n = gang.streaming_covariance_process_local(
                iter(blocks), mesh=gang.global_mesh(), merge=merge)
            walls[f"stream_{merge}"] = time.perf_counter() - t0
            res[f"{merge}_mean"], res[f"{merge}_cov"], res[f"{merge}_n"] = mean, cov, np.asarray(n)
        del blocks
        xg, yg = _glm_logistic_rows(MS_SEED_GLM)
        half = GLM_N // world
        xs, ys = xg[rank * half:(rank + 1) * half].clone(), yg[rank * half:(rank + 1) * half].clone()
        del xg, yg
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        lr = _logistic_config10().setDeployMode("gang").fit((xs, ys))
        res["lr_weights"], res["lr_intercepts"] = lr.weights, lr.intercepts
        res["lr_iter"] = np.asarray(lr.numIter)
        walls["logistic_gang"] = time.perf_counter() - t0
    res["wall_s"] = np.asarray(time.perf_counter() - t_rank)
    res["all_reduce_s"] = np.asarray(reduce_s[0])
    res["walls"] = np.asarray(json.dumps(walls))
    np.savez(os.path.join(out_dir, f"rank{rank}_of_{world}.npz"), **res)
    torch.distributed.destroy_process_group()
    print(f"mesh rank {rank}/{world} ok", flush=True)
    return 0


def _spawn_ranks(world: int, backend: str, out_dir: str) -> list:
    """Start ``world`` ranks of this script (one per ``member_env``), wait
    for them under a timeout, and stop any that outlive it."""
    with contextlib.closing(__import__("socket").socket()) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(rank), "--mesh-world", str(world),
             "--mesh-port", str(port), "--mesh-out", out_dir, "--mesh-backend", backend],
            env=gang.member_env(rank, world), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(world)
    ]
    try:
        outs = [p.communicate(timeout=MS_RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"(c) rank {rank}/{world} failed: {stderr[-2000:]}")
        require(f"mesh rank {rank}/{world} ok" in stdout, f"(c) rank {rank}/{world} printed no result")
    return [dict(np.load(os.path.join(out_dir, f"rank{r}_of_{world}.npz"))) for r in range(world)]


def phase_mesh_gang(a: dict) -> dict:
    """(c) Two processes on the one card (gloo with CUDA tensors: NCCL
    refuses two ranks on one GPU), each holding 1,048,576 x 1,024 float32
    rows from ``SEED + rank``: a gang PCA, the streamed covariance with
    both merges, and a gang logistic fit at config 10's shape (5.5M rows a
    rank); then a world of one over NCCL refitting (a)'s rows. The
    references are computed here, after the ranks have exited."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = _spawn_ranks(MS_RANKS, "gloo", tmp)
        gloo_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        (nccl,) = _spawn_ranks(1, "nccl", tmp)
        nccl_wall = time.perf_counter() - t0
    same = {key: bool(np.array_equal(ranks[0][key], ranks[1][key]))
            for key in ranks[0] if key not in ("wall_s", "all_reduce_s", "walls")}
    # One-process float64 covariance of both ranks' rows, on the card.
    xs = []
    for rank in range(MS_RANKS):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + rank)
        xs.append(planted(MS_N, D, gen))
    n = MS_RANKS * MS_N
    mean = sum(x.double().sum(dim=0) for x in xs) / n
    gram = sum(f64_gram(x[i:i + MS_F64_CHUNK], mean) for x in xs for i in range(0, MS_N, MS_F64_CHUNK))
    cov64 = (gram / (n - 1)).cpu().numpy()
    del xs, gram
    torch.cuda.empty_cache()
    xg, yg = _glm_logistic_rows(MS_SEED_GLM)
    single = _logistic_config10().fit((xg, yg))
    sigma64 = f64_stddev(xg, MS_F64_CHUNK)
    obj_single = logistic_objective64(xg, yg, single.weights, single.intercepts, 0.01, sigma64, MS_F64_CHUNK)
    obj_gang = logistic_objective64(xg, yg, ranks[0]["lr_weights"], ranks[0]["lr_intercepts"], 0.01, sigma64,
                                    MS_F64_CHUNK)
    out = {
        "phase": "mesh_gang", "ranks": MS_RANKS, "backend": "gloo (CUDA tensors)",
        "rows_per_rank": MS_N, "logistic_rows_per_rank": GLM_N // MS_RANKS,
        "ranks_bitwise_equal": same,
        "cov_vs_f64_rel": {m: _rel_err(ranks[0][f"{m}_cov"], cov64) for m in ("psum", "allgather")},
        "rows_merged": {m: int(ranks[0][f"{m}_n"]) for m in ("psum", "allgather")},
        "logistic_objective_rel": abs(obj_gang - obj_single) / abs(obj_single),
        "logistic_num_iter": {"gang": int(ranks[0]["lr_iter"]), "single": single.numIter},
        "rank_wall_s": [float(r["wall_s"]) for r in ranks],
        "rank_all_reduce_s": [float(r["all_reduce_s"]) for r in ranks],
        "rank_step_wall_s": [json.loads(str(r["walls"])) for r in ranks],
        "spawn_to_exit_s": {"gloo_2_ranks": gloo_wall, "nccl_world_of_one": nccl_wall},
        "nccl_world_of_one_equals_mesh_1x1": bool(np.array_equal(nccl["pc"], a["pc_1x1"])
                                                  and np.array_equal(nccl["ev"], a["ev_1x1"])),
        "nccl_wall_s": float(nccl["wall_s"]), "nccl_all_reduce_s": float(nccl["all_reduce_s"]),
    }
    emit(out)
    require(all(same.values()), f"(c) the ranks' results differ: {same}")
    for merge in ("psum", "allgather"):
        require(out["rows_merged"][merge] == n, f"(c) the {merge} merge lost rows")
        require(out["cov_vs_f64_rel"][merge] <= 1e-10, f"(c) the {merge} covariance differs from float64")
    require(out["logistic_objective_rel"] <= 1e-4, "(c) the gang logistic objective differs from one process")
    require(out["logistic_num_iter"]["gang"] == single.numIter, "(c) the gang logistic numIter differs")
    require(out["nccl_world_of_one_equals_mesh_1x1"], "(c) the NCCL world of one differs from (a)'s (1, 1) fit")
    return {"out": out, "logistic": (xg, yg, single, sigma64, obj_single)}


def phase_mesh_families(gen: torch.Generator, logistic) -> dict:
    """(d) Configs 3, 4 and 10 on meshes of the one card: KMeans(100) on
    20M x 16 blobs from pinned initial centres on a (4, 1) mesh against the
    single-device ``xla`` fit; LinearRegression (config 4) and
    LogisticRegression (config 10) on (4, 1) and (2, 2) meshes against the
    float64 solve and the single-device fit."""
    out = {"phase": "mesh_families", "walls_s": {}}
    x, truth = planted_blobs(KM_N, KM_D, KM_K, gen)
    init = near(truth, gen).cpu().numpy()
    km_single = KMeans().setK(KM_K).setBackend("xla").setInitialModel(init)
    km_mesh = KMeans(mesh=_mesh_of((4, 1))).setK(KM_K).setInitialModel(init)
    t0 = time.perf_counter()
    ms = km_mesh.fit(x)
    c_mesh = ms.clusterCenters()
    out["walls_s"]["kmeans_4x1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ss = km_single.fit(x)
    c_single = ss.clusterCenters()
    out["walls_s"]["kmeans_single_xla"] = time.perf_counter() - t0
    out["kmeans"] = {"x": [KM_N, KM_D, KM_K], "num_iter": {"mesh_4x1": ms.numIter, "single": ss.numIter},
                     "centers_max_abs": float(np.abs(c_mesh - c_single).max()),
                     "cost_rel": abs(ms.trainingCost - ss.trainingCost) / abs(ss.trainingCost)}
    del x, truth
    torch.cuda.empty_cache()

    x, w_true = glm_rows(gen)
    y = x @ w_true + 0.1 * torch.randn(GLM_N, generator=gen, device=x.device)
    ref_coef, _ = ridge_f64(*f64_moments(x, y, MS_F64_CHUNK), 0.1)
    scale = float(np.abs(ref_coef).max())
    out["linear"] = {"x": [GLM_N, GLM_D]}
    for name, mesh in (("single", None), ("mesh_4x1", _mesh_of((4, 1))), ("mesh_2x2", _mesh_of((2, 2)))):
        est = LinearRegression(mesh=mesh).setRegParam(0.1)
        coef = est.fit((x, y)).coefficients
        out["walls_s"][f"linear_{name}"] = wall_s(lambda e=est: e.fit((x, y)).coefficients)
        out["linear"][f"{name}_coef_vs_f64_rel_to_max"] = float(np.abs(coef - ref_coef).max()) / scale
    del x, y
    torch.cuda.empty_cache()

    xg, yg, single, sigma64, obj_single = logistic
    out["logistic"] = {"x": [GLM_N, GLM_D], "single_num_iter": single.numIter}
    out["walls_s"]["logistic_single"] = wall_s(lambda: _logistic_config10().fit((xg, yg)).weights, repeats=1)
    for name, shape in (("mesh_4x1", (4, 1)), ("mesh_2x2", (2, 2))):
        est = _logistic_config10()
        est.setMesh(_mesh_of(shape))
        t0 = time.perf_counter()
        model = est.fit((xg, yg))
        w = model.weights
        out["walls_s"][f"logistic_{name}"] = time.perf_counter() - t0
        obj = logistic_objective64(xg, yg, w, model.intercepts, 0.01, sigma64, MS_F64_CHUNK)
        out["logistic"][name] = {"num_iter": model.numIter, "objective_rel": abs(obj - obj_single) / abs(obj_single)}
    emit(out)
    require(out["kmeans"]["num_iter"]["mesh_4x1"] == ss.numIter, "(d) KMeans numIter differs on the mesh")
    require(out["kmeans"]["centers_max_abs"] <= 1e-3, "(d) KMeans centres differ on the mesh")
    require(out["kmeans"]["cost_rel"] <= 1e-4, "(d) KMeans cost differs on the mesh")
    for name in ("single", "mesh_4x1", "mesh_2x2"):
        require(out["linear"][f"{name}_coef_vs_f64_rel_to_max"] <= 1e-4, f"(d) linear {name} differs from float64")
    for name in ("mesh_4x1", "mesh_2x2"):
        require(out["logistic"][name]["num_iter"] == single.numIter, f"(d) logistic {name} numIter differs")
        require(out["logistic"][name]["objective_rel"] <= 1e-4, f"(d) logistic {name} objective differs")
    return out


def mesh_phases(gen: torch.Generator) -> dict:
    """The mesh and multi-process routes, (a)-(d) of the distribution slice,
    with no fallback to the CPU or to one device. Prints the group's wall,
    which must stay within ``MS_WALL_LIMIT_S``."""
    peaks = peaks_for(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    walls = {}
    t = time.perf_counter()
    a = phase_mesh_config5(MS_SEED_A)
    walls["a_config5"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    b = phase_mesh_stream(gen, peaks)
    walls["b_block_step"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    c = phase_mesh_gang(a)
    walls["c_gang"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    d = phase_mesh_families(gen, c["logistic"])
    walls["d_families"] = time.perf_counter() - t
    wall = time.perf_counter() - t0
    emit({"phases": "mesh", "wall_s": wall, "phase_wall_s": walls})
    require(wall <= MS_WALL_LIMIT_S, f"the mesh phases took {wall:.1f} s, over their {MS_WALL_LIMIT_S:.0f} s")
    return {"a": a["out"], "b": b, "c": c["out"], "d": d}


# --- (e) the sharded families: configs 11, 7, 8, 13, 12 and 9 on a (4, 1) mesh --

SH_MESH = (4, 1)
SH_WALL_LIMIT_S = 120.0
SH_SEED = SEED + 300        # the group's data: drawn anew from its own seed


def _timed(fn, repeats: int = 3):
    """``(fn()'s last result, the median of ``repeats`` host walls around
    it and a synchronize)``; the first run warms the caches."""
    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def phase_sharded_knn(items: torch.Tensor, queries: torch.Tensor) -> dict:
    """(e1) Config 11: ``NearestNeighbors(mesh=...).setK(10)`` on the 1M x 96
    items, 10,000 queries, euclidean and cosine, against the single-device
    search of the same rows: indices equal, distances within 1e-5
    relative. Walls are medians of 3 runs; the mesh's first search,
    which includes its upload, is timed alone."""
    out = {"phase": "sharded_knn", "mesh": list(SH_MESH), "walls_s": {}}
    mesh = _mesh_of(SH_MESH)
    for metric in ("euclidean", "cosine"):
        single = NearestNeighbors().setK(NB_K).setMetric(metric).fit(items)
        (d1, i1), out["walls_s"][f"{metric}_single"] = _timed(lambda: single.kneighbors(queries))
        model = NearestNeighbors(mesh=mesh).setK(NB_K).setMetric(metric).fit(items)
        _, out["walls_s"][f"{metric}_mesh_first"] = _timed(lambda: model.kneighbors(queries), repeats=1)
        (d2, i2), out["walls_s"][f"{metric}_mesh"] = _timed(lambda: model.kneighbors(queries))
        out[metric] = {"indices_equal": bool(torch.equal(i1, i2)),
                       "indices_differing": int((i1 != i2).sum()),
                       "dist_rel": float(((d2.double() - d1.double()).abs()
                                          / d1.double().abs().clamp_min(1e-30)).max())}
        if metric == "euclidean":
            out["exact"] = i1
    exact = out.pop("exact")
    emit(out)
    for metric in ("euclidean", "cosine"):
        require(out[metric]["indices_equal"], f"(e1) {metric}: mesh indices differ from the single device's")
        require(out[metric]["dist_rel"] <= 1e-5, f"(e1) {metric}: mesh distances {out[metric]['dist_rel']:.2e}")
    out["exact"] = exact
    return out


def _ann_pair(items, queries, exact, algo: str, params: dict, refine: bool = False) -> dict:
    """A single-device index and a mesh-built one of ``algo``: build and
    search walls, the mesh search of the single-device index (its
    indices exactly), the mesh build's centroids (and codebooks) against
    the single-device build's, and both recalls against ``exact``."""
    mesh = _mesh_of(SH_MESH)
    res = {"walls_s": {}}
    est = ApproximateNearestNeighbors().setK(NB_K).setMetric("sqeuclidean").setAlgorithm(algo).setSeed(SEED)
    single, res["walls_s"]["build_single"] = _timed(lambda: est.setAlgoParams(params).fit(items), repeats=1)
    (d1, i1), res["walls_s"]["search_single"] = _timed(lambda: single.kneighbors(queries))
    single.setMesh(mesh)
    (d2, i2), res["walls_s"]["search_mesh_of_single_index"] = _timed(lambda: single.kneighbors(queries))
    built, res["walls_s"]["build_mesh"] = _timed(
        lambda: est.copy().setMesh(mesh).setAlgoParams(params).fit(items), repeats=1)
    (_, i3), res["walls_s"]["search_mesh_built"] = _timed(lambda: built.kneighbors(queries))
    res.update({
        "mesh_search_indices_equal": bool(torch.equal(i1, i2)),
        "mesh_search_dist_rel": float(((d2.double() - d1.double()).abs()
                                       / d1.double().abs().clamp_min(1e-30)).max()),
        "centroids_rel": _rel(built._index.centroids, single._index.centroids),
        "recall_single": recall_of(i1, exact), "recall_mesh_built": recall_of(i3, exact),
    })
    if algo == "ivfpq":
        res["codebooks_rel"] = _rel(built._index.codebooks, single._index.codebooks)
    res["l_max"] = {"single": int(single._index.list_ids.shape[1]), "mesh_built": int(built._index.list_ids.shape[1])}
    if refine:
        single.setMesh(None)
        single.set(single.algoParams, dict(params, refine_ratio=4))
        built.set(built.algoParams, dict(params, refine_ratio=4))
        (_, r1), res["walls_s"]["refine4_single"] = _timed(lambda: single.kneighbors(queries))
        single.setMesh(mesh)
        (_, r2), res["walls_s"]["refine4_mesh_of_single_index"] = _timed(lambda: single.kneighbors(queries))
        (_, r3), res["walls_s"]["refine4_mesh_built"] = _timed(lambda: built.kneighbors(queries))
        res.update({"refine4_indices_equal": bool(torch.equal(r1, r2)),
                    "refine4_recall_single": recall_of(r1, exact), "refine4_recall_mesh_built": recall_of(r3, exact)})
    return res


def _require_ann(tag: str, res: dict) -> None:
    require(res["mesh_search_indices_equal"], f"{tag} the mesh search of the single-device index differs")
    require(res["centroids_rel"] <= 1e-4, f"{tag} mesh-built centroids {res['centroids_rel']:.2e} from single")
    require(abs(res["recall_mesh_built"] - res["recall_single"]) <= 0.01,
            f"{tag} recall {res['recall_mesh_built']:.4f} against {res['recall_single']:.4f} single")


def phase_sharded_ann(items: torch.Tensor, queries: torch.Tensor, exact: torch.Tensor,
                      gen: torch.Generator) -> dict:
    """(e2) Config 7's ``ivfflat`` (nlist 1,024, nprobe 32) and ``brute`` on
    (e1)'s items and queries; (e3) config 8's ``ivfpq`` (nlist 512, nprobe
    16, M 32, 3 + 3 iterations) on 1M x 128 items and 2,000 queries, with
    ``refine_ratio`` 4. Each: the mesh search of the single-device index
    returns its indices, the mesh-built index's centroids are within 1e-4
    relative of the single-device build's and its recall against exact
    within 0.01 of the single-device build's."""
    out = {"phase": "sharded_ann", "mesh": list(SH_MESH)}
    mesh = _mesh_of(SH_MESH)
    brute = ApproximateNearestNeighbors().setK(NB_K).setMetric("sqeuclidean").setAlgorithm("brute")
    (d1, i1), t1 = _timed(lambda: brute.fit(items).kneighbors(queries))
    (d2, i2), t2 = _timed(lambda: brute.copy().setMesh(mesh).fit(items).kneighbors(queries))
    out["config7_brute"] = {"walls_s": {"single_fit_and_search": t1, "mesh_fit_upload_and_search": t2},
                            "indices_equal": bool(torch.equal(i1, i2)), "dist_rel": rel_err(d2, d1)}
    out["config7_ivfflat"] = _ann_pair(items, queries, exact, "ivfflat", {"nlist": NB_LISTS, "nprobe": NB_PROBE})
    torch.cuda.empty_cache()
    items8 = torch.randn((NB_N, PQ_D), generator=gen, device=gen.device)
    queries8 = torch.randn((PQ_Q, PQ_D), generator=gen, device=gen.device)
    _, exact8 = knn_f64(queries8, items8, NB_K, "sqeuclidean")
    out["config8_ivfpq"] = _ann_pair(items8, queries8, exact8, "ivfpq", PQ_PARAMS, refine=True)
    del items8, queries8
    emit(out)
    require(out["config7_brute"]["indices_equal"], "(e2) brute: mesh indices differ from the single device's")
    require(out["config7_brute"]["dist_rel"] <= 1e-5, "(e2) brute: mesh distances differ")
    _require_ann("(e2) ivfflat:", out["config7_ivfflat"])
    pq = out["config8_ivfpq"]
    _require_ann("(e3) ivfpq:", pq)
    require(pq["refine4_indices_equal"], "(e3) refine_ratio 4: the mesh search differs")
    require(abs(pq["refine4_recall_mesh_built"] - pq["refine4_recall_single"]) <= 0.01,
            "(e3) refine_ratio 4: the mesh-built recall differs")
    return out


def phase_sharded_umap(gen: torch.Generator) -> dict:
    """(e4) Config 13: ``UMAP(mesh=...)`` on 50,000 x 64 blobs -> 2-D (200
    epochs, k = 15), beside the single-device fit (K4 on): the mesh kNN
    graph's indices equal the single-device graph's; trustworthiness
    (k = 10, the 2,000-row subsample) > 0.85 and within 0.03 of the
    single-device fit's; K4 never launched on the mesh."""
    mesh = _mesh_of(SH_MESH)
    truth = torch.randn((UM_BLOBS, UM_D), generator=gen, device=gen.device) * UM_SCALE
    x, _ = umap_blobs(UM_N, truth, gen)
    sub = torch.randperm(UM_N, generator=gen, device=gen.device)[:UM_SUB]
    out = {"phase": "sharded_umap", "mesh": list(SH_MESH), "walls_s": {}}
    (_, i1), out["walls_s"]["graph_single"] = _timed(lambda: _knn_excluding_self(x, UM_K, "euclidean", approx=True))
    (_, i2), out["walls_s"]["graph_mesh"] = _timed(
        lambda: _knn_excluding_self(x, UM_K, "euclidean", mesh, approx=True))
    single, out["walls_s"]["fit_single"] = _timed(lambda: umap_estimator().fit(x))
    k4_before = k4.launches["tail_accumulate"]
    model, out["walls_s"]["fit_mesh"] = _timed(lambda: umap_estimator().setMesh(mesh).fit(x))
    out.update({"graph_indices_equal": bool(torch.equal(i1, i2)), "graph_indices_differing": int((i1 != i2).sum()),
                "k4_launches_on_mesh": k4.launches["tail_accumulate"] - k4_before,
                "trust_single": _umap_trust(x, single._emb_raw, sub),
                "trust_mesh": _umap_trust(x, model._emb_raw, sub),
                "finite": bool(torch.isfinite(model._emb_raw).all())})
    emit(out)
    require(out["graph_indices_equal"], "(e4) the mesh kNN graph differs from the single-device graph")
    require(out["k4_launches_on_mesh"] == 0, "(e4) K4 launched on the mesh")
    require(out["finite"] and out["trust_mesh"] > 0.85, f"(e4) mesh trustworthiness {out['trust_mesh']:.4f}")
    require(abs(out["trust_mesh"] - out["trust_single"]) <= 0.03,
            f"(e4) trustworthiness {out['trust_mesh']:.4f} against {out['trust_single']:.4f} single")
    return out


def phase_sharded_dbscan_forest(gen: torch.Generator) -> dict:
    """(e5) Config 12: ``DBSCAN(mesh=...).setEps(2.0).setMinSamples(8)`` on
    100,000 x 16 blobs: labels and core mask equal to the single-device
    fit's. (e6) Config 9: ``RandomForestClassifier(mesh=...)``, 8 trees,
    depth 6, 16 bins, on 500,000 x 16: every ``Forest`` field bitwise the
    single-device fit from the same draws; the regressor's RMSE within
    1 % of its single-device fit's."""
    mesh = _mesh_of(SH_MESH)
    out = {"phase": "sharded_dbscan_forest", "mesh": list(SH_MESH), "walls_s": {}}
    centres = torch.randn((DB_BLOBS, DB_D), generator=gen, device=gen.device) * 12.0
    x = dbscan_blobs(DB_N, centres, gen)
    est = DBSCAN().setEps(DB_EPS).setMinSamples(DB_MIN_SAMPLES)
    single, out["walls_s"]["dbscan_single"] = _timed(lambda: est.fit(x))
    model, out["walls_s"]["dbscan_mesh"] = _timed(lambda: est.copy().setMesh(mesh).fit(x))
    out["dbscan"] = {"labels_equal": bool(np.array_equal(model.labels_, single.labels_)),
                     "labels_differing": int((model.labels_ != single.labels_).sum()),
                     "core_equal": bool(np.array_equal(model.core_mask_, single.core_mask_)),
                     "clusters": int(model.labels_.max()) + 1}
    del x
    xf, margin = forest_rows(gen)
    y = (margin > 0).to(torch.float32)
    clf = (RandomForestClassifier().setNumTrees(RF_TREES).setMaxDepth(RF_DEPTH).setMaxBins(RF_BINS)
           .setNumClasses(2).setSeed(SEED))
    f1, out["walls_s"]["forest_single"] = _timed(lambda: clf.fit((xf, y)))
    f2, out["walls_s"]["forest_mesh"] = _timed(lambda: clf.copy().setMesh(mesh).fit((xf, y)))
    out["forest"] = {f: bool(torch.equal(getattr(f1._forest, f), getattr(f2._forest, f)))
                     for f in f1._forest._fields}
    reg = RandomForestRegressor().setNumTrees(RF_TREES).setMaxDepth(RF_DEPTH).setMaxBins(RF_BINS).setSeed(SEED)
    r1, out["walls_s"]["regressor_single"] = _timed(lambda: reg.fit((xf, margin)))
    r2, out["walls_s"]["regressor_mesh"] = _timed(lambda: reg.copy().setMesh(mesh).fit((xf, margin)))
    rmse = [float(torch.sqrt(torch.mean((r.predict(xf) - margin) ** 2))) for r in (r1, r2)]
    out["regressor"] = {"rmse_single": rmse[0], "rmse_mesh": rmse[1], "rmse_rel": abs(rmse[1] - rmse[0]) / rmse[0]}
    emit(out)
    require(out["dbscan"]["labels_equal"] and out["dbscan"]["core_equal"],
            f"(e5) mesh DBSCAN differs from the single-device fit: {out['dbscan']}")
    require(all(out["forest"].values()), f"(e6) mesh forest fields differ: {out['forest']}")
    require(out["regressor"]["rmse_rel"] <= 0.01, f"(e6) regressor RMSE {out['regressor']}")
    return out


def sharded_phases() -> dict:
    """Group (e), the sharded families: configs 11, 7, 8, 13, 12 and 9 at
    full shape on a (4, 1) mesh of the one card, each beside its
    single-device fit of the same rows (walls: medians of 3 runs, the
    IVF / PQ builds one run each); no fallback to the CPU or to one
    device. Its own seed; prints its wall, within ``SH_WALL_LIMIT_S``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SH_SEED)
    t0 = time.perf_counter()
    walls = {}
    t = time.perf_counter()
    items = torch.randn((NB_N, NB_D), generator=gen, device=gen.device)
    queries = torch.randn((NB_Q, NB_D), generator=gen, device=gen.device)
    knn_out = phase_sharded_knn(items, queries)
    walls["e1_config11"] = time.perf_counter() - t
    t = time.perf_counter()
    ann_out = phase_sharded_ann(items, queries, knn_out.pop("exact"), gen)
    walls["e2_e3_configs7_8"] = time.perf_counter() - t
    del items, queries
    torch.cuda.empty_cache()
    t = time.perf_counter()
    umap_out = phase_sharded_umap(gen)
    walls["e4_config13"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    df_out = phase_sharded_dbscan_forest(gen)
    walls["e5_e6_configs12_9"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    emit({"phases": "sharded", "wall_s": wall, "phase_wall_s": walls})
    require(wall <= SH_WALL_LIMIT_S, f"the sharded phases took {wall:.1f} s, over their {SH_WALL_LIMIT_S:.0f} s")
    return {"knn": knn_out, "ann": ann_out, "umap": umap_out, "dbscan_forest": df_out}


RB_PCA_N = 262_144          # (a): 1,024 features (bench.py's width), rows cut to keep the group's time
RB_STREAM_ITERS = 3         # (a): Lloyd passes of the OOM-recovered streaming KMeans fit
RB_EVERY = {"config3_kmeans": 1, "config4_enet": 20, "config10_lbfgs": 5, "config13_umap": 50}
RB_SEED = SEED + 400        # the group's data: drawn anew from its own seed
RB_KILL_UID = "robust-kill"
RB_CHILD_TIMEOUT_S = 90
RB_WALL_LIMIT_S = 60.0


def robust_config3_rows() -> torch.Tensor:
    """Config 3's 20M x 16 float32 blobs from the group's own seed: (c)'s
    fits and (d)'s child draw the same rows on the same card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(RB_SEED)
    return planted_blobs(KM_N, KM_D, KM_K, gen)[0]


def _config3_kmeans(uid: str = "robust-km") -> KMeans:
    return KMeans(uid=uid).setK(KM_K).setSeed(SEED).setBackend("xla")


def _ckpt_files(root: str) -> list:
    return glob.glob(os.path.join(root, "*", "ckpt-*.npz"))


def phase_robust_placement(gen: torch.Generator) -> dict:
    """(f-a) A host PCA fit (1,024 features, ``pallas``: K1 on the host
    partition) under ``ingest.device_put=2`` is bitwise the clean fit, with
    2 failed attempts on the ``retry.*`` counters and K1 launched as often
    as in one clean fit; under ``always`` it raises ``RetryExhaustedError``
    and the device memory comes back; under ``:fatal`` it raises after one
    attempt. Then config 3's rows on the host, degraded to the streaming
    KMeans fit under a 256 MiB budget, meet ``solver.segment=1:oom``: the
    fit halves its block rows once and equals the explicit reader fit of
    the halved blocks (C4's recovery, driven by the spec)."""
    out = {"phase": "robust_placement", "rows": RB_PCA_N, "d": D}
    host = planted(RB_PCA_N, D, gen).cpu().numpy()
    est = PCA().setK(K).setCovarianceBackend("pallas")
    attempts = "retry.ingest.device_put.attempts"
    walls, launches, tries = {"clean": [], "faulted": []}, {"clean": [], "faulted": []}, {"clean": [], "faulted": []}
    fired = []
    for run in ("clean", "faulted") * 3:
        k0, a0 = k1.launches, counter_value(attempts)
        with (inject("ingest.device_put=2") if run == "faulted" else contextlib.nullcontext()) as plan:
            sync()
            t0 = time.perf_counter()
            model = est.fit(host)
            sync()
        walls[run].append(time.perf_counter() - t0)
        launches[run].append(k1.launches - k0)
        tries[run].append(counter_value(attempts) - a0)
        if run == "clean":
            clean = model
        else:
            faulted = model
            fired.append(len(plan.fired))
    out["walls_s"] = {run: statistics.median(w) for run, w in walls.items()}
    out["k1_launches"] = launches
    out["placement_attempts"] = tries
    out["failed_attempts"] = [f - c for f, c in zip(tries["faulted"], tries["clean"])]
    out["bitwise_equal"] = _same_pca(clean, faulted)
    sync()
    mem0 = torch.cuda.memory_allocated()
    exhausted = None
    with inject("ingest.device_put=always") as plan:
        try:
            est.fit(host)
        except RetryExhaustedError as exc:
            exhausted = f"{exc.attempts} {type(exc.__cause__).__name__}"
    sync()
    out["exhausted"] = {"error": exhausted, "invocations": plan.invocations("ingest.device_put"),
                        "allocated_before": mem0, "allocated_after": torch.cuda.memory_allocated()}
    with inject("ingest.device_put=always:fatal") as plan:
        try:
            est.fit(host)
            fatal = None
        except InjectedFault as exc:
            fatal = type(exc).__name__
    out["fatal"] = {"error": fatal, "invocations": plan.invocations("ingest.device_put")}
    del host

    xk_host = robust_config3_rows().cpu().numpy()
    torch.cuda.empty_cache()
    km = KMeans().setK(KM_K).setSeed(SEED).setMaxIter(RB_STREAM_ITERS).setBackend("xla")
    with knob(TPUML_FIT_MEM_BUDGET=SMALL_BUDGET, TPUML_FIT_BLOCK_ROWS=KM_ST_BLOCK):
        halved = fit_block_rows("kmeans", width=KM_D, itemsize=4) // 2
        h0 = counter_value("fit.oom.block_halved")
        with inject("solver.segment=1:oom") as plan, warnings.catch_warnings():
            warnings.simplefilter("ignore", DegradationWarning)
            t0 = time.perf_counter()
            recovered = km.fit(xk_host)
            rec_wall = time.perf_counter() - t0
        halvings = counter_value("fit.oom.block_halved") - h0
    t0 = time.perf_counter()
    explicit = km.fit(HostArrayBlockReader(xk_host, block_rows=halved))
    out["stream_oom"] = {
        "fired": plan.fired, "block_halved": halvings, "halved_block_rows": halved,
        "recovered_wall_s": rec_wall, "explicit_wall_s": time.perf_counter() - t0,
        "bitwise_equal": bool(np.array_equal(recovered.clusterCenters(), explicit.clusterCenters())
                              and recovered.trainingCost == explicit.trainingCost
                              and recovered.numIter == explicit.numIter)}
    del xk_host
    out["clean_model"] = clean
    emit({k: v for k, v in out.items() if k != "clean_model"})
    require(out["bitwise_equal"], "(f-a) the retried placement's PCA differs from the clean fit")
    require(out["failed_attempts"] == [2, 2, 2] and fired == [2, 2, 2],
            f"(f-a) failed attempts {out['failed_attempts']}, fired {fired}")
    require(launches["faulted"] == launches["clean"] and min(launches["clean"]) > 0,
            f"(f-a) K1 launches {launches}")
    require(exhausted == "3 InjectedFault", f"(f-a) exhaustion gave {exhausted}")
    require(out["exhausted"]["allocated_after"] == mem0, f"(f-a) exhaustion kept memory: {out['exhausted']}")
    require(fatal == "InjectedFault" and out["fatal"]["invocations"] == 1, f"(f-a) the fatal fault: {out['fatal']}")
    require(halvings == 1 and plan.fired == [("solver.segment", 0)] and out["stream_oom"]["bitwise_equal"],
            f"(f-a) the streaming OOM recovery: {out['stream_oom']}")
    return out


def phase_robust_persistence(model, tmp: str) -> dict:
    """(f-b) A save under ``persistence.write=1`` round-trips bitwise; an
    overwrite killed midway (``:fatal``) leaves the previous model in
    place, loadable and bitwise."""
    path = os.path.join(tmp, "pca")
    with inject("persistence.write=1") as plan:
        t0 = time.perf_counter()
        model.write.overwrite().save(path)
        wall = time.perf_counter() - t0
    roundtrip = _same_pca(PCAModel.load(path), model)
    other = PCAModel("other", -model.pc, model.explainedVariance)
    with inject("persistence.write=always:fatal"):
        try:
            other.write.overwrite().save(path)
            killed = None
        except InjectedFault as exc:
            killed = type(exc).__name__
    kept = _same_pca(PCAModel.load(path), model)
    out = {"phase": "robust_persistence", "fired": plan.fired, "save_wall_s": wall,
           "roundtrip_bitwise": roundtrip, "killed": killed, "previous_kept_bitwise": kept,
           "stray_temp_dirs": glob.glob(os.path.join(tmp, ".pca.tmp-save*"))}
    emit(out)
    require(plan.fired == [("persistence.write", 0)] and roundtrip, f"(f-b) the retried save: {out}")
    require(killed == "InjectedFault" and kept and not out["stray_temp_dirs"], f"(f-b) the killed save: {out}")
    return out


def _robust_family(name: str, fit, read, tmp: str, **knobs) -> dict:
    """(f-c) for one family: the monolithic and the segmented fit (medians
    of 3 walls; bitwise equal), then a fit killed at its first segment
    boundary (``checkpoint.segment=1:fatal``) and a refit that resumes
    from its snapshot: bitwise the uninterrupted fit, with strictly fewer
    solver iterations and the reference's sum rule."""
    root = tempfile.mkdtemp(prefix=f"ckpt-{name}-", dir=tmp)
    out = {"family": name, "every": RB_EVERY[name]}
    with knob(TPUML_CHECKPOINT_DIR=root, TPUML_CHECKPOINT_EVERY=0, **knobs):
        mono, out["monolithic_wall_s"] = _timed(fit)
    want = read(mono)
    k4_0 = k4.launches["tail_accumulate"]
    with knob(TPUML_CHECKPOINT_DIR=root, TPUML_CHECKPOINT_EVERY=RB_EVERY[name], **knobs):
        clear_counters("checkpoint")
        seg, out["segmented_wall_s"] = _timed(fit)
        out["segmented_equal"] = read(seg) == want
        out["snapshots_per_fit"] = counter_value("checkpoint.write") / 3
        out["segments_per_fit"] = counter_value("checkpoint.segments") / 3
        full = counter_value("checkpoint.solver_iters") // 3
        out["k4_launches_per_fit"] = (k4.launches["tail_accumulate"] - k4_0) / 3
        clear_counters("checkpoint")
        k4_0 = k4.launches["tail_accumulate"]
        with inject("checkpoint.segment=1:fatal"):
            try:
                fit()
                killed = None
            except InjectedFault as exc:
                killed = type(exc).__name__
        killed_iters = counter_value("checkpoint.solver_iters")
        out["files_after_kill"] = len(_ckpt_files(root))
        clear_counters("checkpoint")
        t0 = time.perf_counter()
        resumed = fit()
        sync()
        out["resumed_wall_s"] = time.perf_counter() - t0
        out["k4_launches_killed_and_resumed"] = k4.launches["tail_accumulate"] - k4_0
    out.update({"killed": killed, "solver_iters": full, "killed_iters": killed_iters,
                "restored": counter_value("checkpoint.restore"),
                "restored_step": counter_value("checkpoint.restore.steps"),
                "resumed_iters": counter_value("checkpoint.solver_iters"),
                "resumed_equal": read(resumed) == want, "files_left": len(_ckpt_files(root))})
    out["want"] = want
    return out


def _require_family(res: dict) -> None:
    name = res["family"]
    require(res["segmented_equal"], f"(f-c) {name}: the segmented fit differs from the monolithic fit")
    require(res["segments_per_fit"] >= 2 and res["snapshots_per_fit"] == res["segments_per_fit"],
            f"(f-c) {name}: {res['segments_per_fit']} segments, {res['snapshots_per_fit']} snapshots a fit")
    require(res["killed"] == "InjectedFault" and res["files_after_kill"] >= 1, f"(f-c) {name}: the kill {res}")
    require(res["resumed_equal"] and res["restored"] == 1, f"(f-c) {name}: the resumed fit {res}")
    require(res["resumed_iters"] < res["solver_iters"]
            and res["resumed_iters"] + res["restored_step"] == res["solver_iters"],
            f"(f-c) {name}: iterations {res}")
    require(res["files_left"] == 0, f"(f-c) {name}: a completed fit left snapshots")


def _umap_with_uid(uid: str) -> UMAP:
    return (UMAP(uid=uid).setNNeighbors(UM_K).setNComponents(UM_DIM).setNEpochs(UM_EPOCHS)
            .setBuildAlgo("brute_approx").setInit("random").setSeed(SEED))


def phase_robust_checkpoints(gen: torch.Generator, tmp: str) -> dict:
    """(f-c) Configs 3 (KMeans k = 100, ``xla``), 4 (elastic-net FISTA), 10
    (L-BFGS) and 13 (UMAP, K4 every epoch, ``TPUML_CHECKPOINT_UMAP=1``) at
    full shape: segmented = monolithic and killed-then-resumed =
    uninterrupted, bitwise; UMAP's killed and resumed fits launch K4 200
    times between them (no epoch is lost: the kill lands after a committed
    snapshot). The index_add_ tail route's segmented layout is recorded."""
    res = {}
    x = robust_config3_rows()
    res["config3_kmeans"] = _robust_family(
        "config3_kmeans", lambda: _config3_kmeans().fit(x),
        lambda m: (m.clusterCenters().tobytes(), m.trainingCost, m.numIter), tmp)
    del x
    torch.cuda.empty_cache()
    xg, w_true = glm_rows(gen)
    yl = xg @ w_true + 0.1 * torch.randn(GLM_N, generator=gen, device=xg.device)
    res["config4_enet"] = _robust_family(
        "config4_enet",
        lambda: LinearRegression(uid="robust-enet").setRegParam(0.1).setElasticNetParam(0.5).fit((xg, yl)),
        lambda m: (m.coefficients.tobytes(), m.intercept), tmp)
    del yl
    margin = (xg - xg.mean(dim=0)) / xg.std(dim=0) @ w_true + 0.5 * torch.randn(GLM_N, generator=gen,
                                                                                 device=xg.device)
    yb = (margin > 0).float()
    del margin
    res["config10_lbfgs"] = _robust_family(
        "config10_lbfgs",
        lambda: LogisticRegression(uid="robust-logreg").setRegParam(0.01).setMaxIter(20).setTol(0.0)
        .fit((xg, yb)),
        lambda m: (m.coefficients.tobytes(), m.intercept, m.numIter), tmp)
    del xg, yb
    torch.cuda.empty_cache()
    truth = torch.randn((UM_BLOBS, UM_D), generator=gen, device=gen.device) * UM_SCALE
    xu, _ = umap_blobs(UM_N, truth, gen)

    def read_umap(m):
        return m._emb_raw.cpu().numpy().tobytes()

    res["config13_umap"] = _robust_family("config13_umap", lambda: _umap_with_uid("robust-umap").fit(xu),
                                          read_umap, tmp, TPUML_CHECKPOINT_UMAP=1)
    root = tempfile.mkdtemp(prefix="ckpt-umap-xla-", dir=tmp)
    with knob(TPUML_UMAP_SCATTER="xla", TPUML_CHECKPOINT_DIR=root, TPUML_CHECKPOINT_UMAP=1):
        with knob(TPUML_CHECKPOINT_EVERY=0):
            mono = read_umap(_umap_with_uid("robust-umap-xla").fit(xu))
            again = read_umap(_umap_with_uid("robust-umap-xla").fit(xu))
        with knob(TPUML_CHECKPOINT_EVERY=RB_EVERY["config13_umap"]):
            seg = read_umap(_umap_with_uid("robust-umap-xla").fit(xu))
    index_add = {"monolithic_repeat_equal": mono == again, "segmented_equal": seg == mono}
    summary = {name: {k: v for k, v in r.items() if k != "want"} for name, r in res.items()}
    emit({"phase": "robust_checkpoints", "families": summary, "umap_index_add_route": index_add})
    for r in res.values():
        _require_family(r)
    u = res["config13_umap"]
    require(u["k4_launches_per_fit"] == UM_EPOCHS and u["k4_launches_killed_and_resumed"] == UM_EPOCHS,
            f"(f-c) K4 launches: {u['k4_launches_per_fit']} a fit, "
            f"{u['k4_launches_killed_and_resumed']} killed and resumed")
    return res


def robust_child_main(argv) -> int:
    """(f-d)'s child: config 3's KMeans fit with checkpoints on, started by
    :func:`phase_robust_kill` with ``TPUML_FAULTS`` freezing it at its
    first segment boundary, where it is SIGKILLed."""
    port_device.set_platform("cuda")
    port_device.use_ieee_fp32_matmul()
    _config3_kmeans(RB_KILL_UID).fit(robust_config3_rows())
    print("robust child completed", flush=True)
    return 0


def phase_robust_kill(want, tmp: str) -> dict:
    """(f-d) A child process fits config 3's KMeans with checkpoints on and
    freezes at its first segment boundary (``checkpoint.segment=always:
    stall``, after the snapshot committed); once the first ``ckpt-*.npz``
    exists the parent SIGKILLs it, tearing its CUDA context down. A refit
    here resumes from that snapshot and is bitwise (c)'s uninterrupted fit."""
    root = tempfile.mkdtemp(prefix="ckpt-kill-", dir=tmp)
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUML_")}
    env.update(TPUML_CHECKPOINT_DIR=root, TPUML_CHECKPOINT_EVERY=str(RB_EVERY["config3_kmeans"]),
               TPUML_FAULTS="checkpoint.segment=always:stall")
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--robust-child"], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        while not _ckpt_files(root) and child.poll() is None and time.perf_counter() - t0 < RB_CHILD_TIMEOUT_S:
            time.sleep(0.02)
        first_snapshot_s = time.perf_counter() - t0
        files = _ckpt_files(root)
        if child.poll() is None:
            child.send_signal(signal.SIGKILL)
        _, stderr = child.communicate(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    with knob(TPUML_CHECKPOINT_DIR=root, TPUML_CHECKPOINT_EVERY=RB_EVERY["config3_kmeans"]):
        clear_counters("checkpoint")
        t1 = time.perf_counter()
        m = _config3_kmeans(RB_KILL_UID).fit(robust_config3_rows())
        wall = time.perf_counter() - t1
    out = {"phase": "robust_kill", "first_snapshot_s": first_snapshot_s, "snapshots_at_kill": [os.path.basename(f)
           for f in files], "child_returncode": child.returncode, "resume_wall_s": wall,
           "restored": counter_value("checkpoint.restore"), "restored_step": counter_value("checkpoint.restore.steps"),
           "resumed_iters": counter_value("checkpoint.solver_iters"),
           "resumed_equal": (m.clusterCenters().tobytes(), m.trainingCost, m.numIter) == want}
    emit(out)
    require(files and child.returncode == -signal.SIGKILL, f"(f-d) the child was not killed after a snapshot: "
            f"{out}; {stderr[-2000:]}")
    require(out["restored"] == 1 and out["restored_step"] == RB_EVERY["config3_kmeans"] and out["resumed_equal"],
            f"(f-d) the resumed fit: {out}")
    return out


def robustness_phases() -> dict:
    """Group (f), robustness: (a) placement under faults, (b) persistence
    under faults, (c) checkpointed fits at configs 3, 4, 10 and 13, (d) a
    real kill; its own seed, within ``RB_WALL_LIMIT_S``. Walls are medians
    of 3 where (c) says so; checkpoints go to a temporary directory."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(RB_SEED)
    t0 = time.perf_counter()
    walls = {}
    with tempfile.TemporaryDirectory(prefix="robust-") as tmp:
        t = time.perf_counter()
        a = phase_robust_placement(gen)
        walls["a_placement"] = time.perf_counter() - t
        t = time.perf_counter()
        b = phase_robust_persistence(a.pop("clean_model"), tmp)
        walls["b_persistence"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        c = phase_robust_checkpoints(gen, tmp)
        walls["c_checkpoints"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        d = phase_robust_kill(c["config3_kmeans"]["want"], tmp)
        walls["d_kill"] = time.perf_counter() - t
    wall = time.perf_counter() - t0
    emit({"phases": "robustness", "wall_s": wall, "phase_wall_s": walls})
    require(wall <= RB_WALL_LIMIT_S, f"the robustness phases took {wall:.1f} s, over their {RB_WALL_LIMIT_S:.0f} s")
    return {"placement": a, "persistence": b, "checkpoints": c, "kill": d}


# --- (g) lifecycle: partial_fit, the journaled controller, drift, a kill ----

LC_SEED = SEED + 500        # the group's data: drawn anew from its own seeds
LC_PCA_N = 1_048_576        # (a): config 5's width, the rows one card holds with a float64 reference
LC_PCA_CALLS = 4            # (a): partial_fit calls of 262,144 rows each
LC_CYCLE_N = 2_000_000      # (b)-(e): fresh rows a refit or a cycle takes (a tenth of config 3's table)
LC_SHIFT = 4.0              # (d): every blob centre moves by this much in every feature
LC_WINDOW = 500             # (d): served single rows per drift window
LC_CHILD_TIMEOUT_S = 90
LC_WALL_LIMIT_S = 60.0
LC_KILL_SPEC = "refit.ingest=1@1:fatal"  # the second hit of refit.ingest: the refit stage
#: The refits' Lloyd tolerance (a distance): half the blobs' unit noise, so a
#: refit stops once its centres move less than the sampling noise. At the
#: default 1e-4 a warm and a cold refit both run 2 iterations on blobs this far
#: apart (the second moves the float32 centres by exactly 0).
LC_TOL = 0.5


def lc_generator(offset: int) -> torch.Generator:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(LC_SEED + offset)
    return gen


def lc_truth() -> torch.Tensor:
    """Config 3's k = 100 blob centres over 16 features, from the group's
    seed: the parent and (e)'s child draw the same blobs."""
    return KM_SCALE * torch.randn((KM_K, KM_D), generator=lc_generator(0), device="cuda")


def blob_rows(n: int, truth: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """n fresh rows around ``truth`` with unit noise, made on the card."""
    x = torch.empty((n, truth.shape[1]), device=truth.device)
    x.normal_(generator=gen)
    x += truth[torch.randint(0, truth.shape[0], (n,), generator=gen, device=truth.device)]
    return x


def lc_cycle_rows(truth: torch.Tensor) -> np.ndarray:
    """(e)'s cycle: 2,000,000 rows of the shifted blobs from their own seed,
    as the host rows a controller ingests."""
    return blob_rows(LC_CYCLE_N, truth + LC_SHIFT, lc_generator(5)).cpu().numpy()


def lc_kmeans() -> KMeans:
    """The refitting estimator of (b), (d) and (e): config 3's KMeans."""
    return KMeans().setK(KM_K).setSeed(SEED).setTol(LC_TOL)


def lc_score(model, x, y) -> float:
    """Minus the mean squared distance of the held-out rows to their
    nearest centre, computed on the card (``computeCost``)."""
    return -model.computeCost(x) / x.shape[0]


def _moments_fields(mom) -> tuple:
    return (mom.n_rows, mom.shift.tobytes(), mom.sum.tobytes(), mom.gram.tobytes())


def phase_lifecycle_pca() -> dict:
    """(g-a) Config 5's width: a 1,048,576 x 1,024 float32 CUDA tensor
    folded by ``PCA.partial_fit`` in 4 calls of 262,144 rows, against one
    call over all the rows and the on-card float64 fit. Every CUDA block
    folds through K1's float64 route (one launch a block, as its plan says);
    the previous model's moments are left as they were after each call."""
    x = planted(LC_PCA_N, D, lc_generator(1))
    est = PCA().setK(K)
    rows = LC_PCA_N // LC_PCA_CALLS
    model, walls, launches, want_launches, prev_kept = None, [], [], [], []
    for i in range(LC_PCA_CALLS):
        block = x[i * rows:(i + 1) * rows]
        before = None if model is None else _moments_fields(model._moments)
        k1.reset_launches()
        sync()
        t0 = time.perf_counter()
        nxt = est.partial_fit(block, model=model)
        sync()
        walls.append(time.perf_counter() - t0)
        launches.append(k1.launches)
        want_launches.append(-(-rows // k1.launch_rows(rows, D, torch.float64)))
        if model is not None:
            prev_kept.append(_moments_fields(model._moments) == before)
        model = nxt
    k1.reset_launches()
    sync()
    t0 = time.perf_counter()
    one = est.partial_fit(x)
    sync()
    one_wall = time.perf_counter() - t0
    one_launches = k1.launches
    mean = sum(x[i:i + rows].double().sum(dim=0) for i in range(0, LC_PCA_N, rows)) / LC_PCA_N
    gram = sum(f64_gram(x[i:i + rows], mean) for i in range(0, LC_PCA_N, rows))
    w, v = torch.linalg.eigh(gram / (LC_PCA_N - 1))
    w, v = torch.flip(w, (0,)), sign_flip(torch.flip(v, (1,)))
    ev64 = (w / w.clamp_min(0).sum())[:K].cpu().numpy()
    pc64 = v[:, :K].cpu().numpy()
    del x, gram
    torch.cuda.empty_cache()
    m, o = model._moments, one._moments
    out = {
        "phase": "lifecycle_pca", "rows": LC_PCA_N, "d": D, "calls": LC_PCA_CALLS,
        "partial_fit_wall_s": walls, "one_call_wall_s": one_wall,
        "k1_launches_per_call": launches, "k1_launches_planned": want_launches,
        "k1_launches_one_call": one_launches,
        "merged_vs_one": {"n": [m.n_rows, o.n_rows], "sum_rel": _rel_max(m.sum, o.sum),
                          "gram_rel": _rel_max(m.gram, o.gram)},
        "pc_vs_f64_max_abs": _pc_err_aligned(model.pc, pc64),
        "ev_vs_f64_max_abs": float(np.abs(model.explainedVariance - ev64).max()),
        "previous_moments_kept": prev_kept,
    }
    emit(out)
    require(launches == want_launches and min(launches) > 0
            and one_launches == -(-LC_PCA_N // k1.launch_rows(LC_PCA_N, D, torch.float64)),
            f"(g-a) K1 launches {launches} / {one_launches}, planned {want_launches}")
    require(m.n_rows == o.n_rows == LC_PCA_N and out["merged_vs_one"]["sum_rel"] <= 1e-12
            and out["merged_vs_one"]["gram_rel"] <= 1e-12, f"(g-a) merged moments: {out['merged_vs_one']}")
    require(out["pc_vs_f64_max_abs"] <= 1e-5 and out["ev_vs_f64_max_abs"] <= 1e-6,
            f"(g-a) against the float64 fit: {out['pc_vs_f64_max_abs']}, {out['ev_vs_f64_max_abs']}")
    require(all(prev_kept) and len(prev_kept) == LC_PCA_CALLS - 1, f"(g-a) a previous model moved: {prev_kept}")
    return out


def _iters(fn):
    before = counter_value("checkpoint.solver_iters")
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, counter_value("checkpoint.solver_iters") - before, time.perf_counter() - t0


def _kmeans_bits(m) -> tuple:
    return (m.clusterCenters().tobytes(), m.trainingCost, m.numIter)


def phase_lifecycle_kmeans(truth: torch.Tensor) -> dict:
    """(g-b) Config 3: the incumbent fitted by ``fit`` on ``auto`` over
    20M x 16 (K2, 3 launches), then ``partial_fit`` on a fresh 2,000,000-row
    draw from the same blobs, warm-seeded from the incumbent, against
    ``partial_fit(model=None)`` of the same rows: strictly fewer solver
    iterations; the cold call bitwise a ``setBackend("xla")`` fit (the
    segmented route takes ``xla``, so K2 does not launch there)."""
    x = blob_rows(KM_N, truth, lc_generator(2))
    kk.reset_launches()
    sync()
    t0 = time.perf_counter()
    incumbent = KMeans().setK(KM_K).setSeed(SEED).fit(x)
    sync()
    fit_wall = time.perf_counter() - t0
    k2 = kk.launches["assign_stats_fused"]
    del x
    torch.cuda.empty_cache()
    x2 = blob_rows(LC_CYCLE_N, truth, lc_generator(3))
    est = lc_kmeans()
    kk.reset_launches()
    warm, warm_iters, warm_wall = _iters(lambda: est.partial_fit(x2, model=incumbent))
    cold, cold_iters, cold_wall = _iters(lambda: est.partial_fit(x2))
    pf_k2 = kk.launches["assign_stats_fused"] + kk.launches["assign_stats_packed"]
    plain = est.copy().setBackend("xla").fit(x2)
    out = {"phase": "lifecycle_kmeans", "incumbent_rows": KM_N, "refit_rows": LC_CYCLE_N, "k": KM_K,
           "incumbent_fit_wall_s": fit_wall, "incumbent_k2_launches": k2, "incumbent_num_iter": incumbent.numIter,
           "warm": {"solver_iters": warm_iters, "wall_s": warm_wall, "cost": warm.trainingCost},
           "cold": {"solver_iters": cold_iters, "wall_s": cold_wall, "cost": cold.trainingCost},
           "partial_fit_k2_k3_launches": pf_k2, "cold_bitwise_xla_fit": _kmeans_bits(cold) == _kmeans_bits(plain)}
    emit(out)
    require(k2 == 3, f"(g-b) the incumbent's fit launched K2 {k2} times, not 3")
    require(0 < warm_iters < cold_iters, f"(g-b) warm {warm_iters} iterations, cold {cold_iters}")
    require(out["cold_bitwise_xla_fit"], "(g-b) the cold partial_fit differs from the xla fit")
    require(pf_k2 == 0, f"(g-b) the segmented refits launched K2/K3 {pf_k2} times")
    return {"out": out, "incumbent": incumbent}


def phase_lifecycle_glm() -> dict:
    """(g-c) Configs 4 (elastic net) and 10 (logistic) at full shape: a
    previous model fitted on one draw of 11M x 28 rows seeds ``partial_fit``
    on a second draw. Warm runs strictly fewer solver iterations than cold;
    cold is bitwise a plain fit; warm is within 1e-4 of max|w| (linear) or
    1e-4 in the float64 objective (logistic) of cold."""
    gen = lc_generator(4)
    out = {"phase": "lifecycle_glm"}
    x_a, w_true = glm_rows(gen)
    x_b = torch.randn(x_a.shape, generator=gen, dtype=x_a.dtype, device=x_a.device)
    mu, sd = x_a.mean(dim=0), x_a.std(dim=0)
    x_b.mul_(sd).add_(mu)
    for name in ("config4_enet", "config10_logistic"):
        if name == "config4_enet":
            def make():
                return LinearRegression().setRegParam(0.1).setElasticNetParam(0.5)

            ya = x_a @ w_true + 0.1 * torch.randn(GLM_N, generator=gen, device=x_a.device)
            yb = x_b @ w_true + 0.1 * torch.randn(GLM_N, generator=gen, device=x_a.device)
        else:
            def make():
                return LogisticRegression().setRegParam(0.01).setMaxIter(100)

            ya = (((x_a - mu) / sd) @ w_true + 0.5 * torch.randn(GLM_N, generator=gen, device=x_a.device) > 0).float()
            yb = (((x_b - mu) / sd) @ w_true + 0.5 * torch.randn(GLM_N, generator=gen, device=x_a.device) > 0).float()
        prev = make().fit((x_a, ya))
        warm, warm_iters, warm_wall = _iters(lambda: make().partial_fit((x_b, yb), model=prev))
        cold, cold_iters, cold_wall = _iters(lambda: make().partial_fit((x_b, yb)))
        plain = make().fit((x_b, yb))
        res = {"warm": {"solver_iters": warm_iters, "wall_s": warm_wall},
               "cold": {"solver_iters": cold_iters, "wall_s": cold_wall}}
        if name == "config4_enet":
            res["cold_bitwise_plain_fit"] = (cold.coefficients.tobytes() == plain.coefficients.tobytes()
                                             and cold.intercept == plain.intercept)
            res["warm_vs_cold_rel_max_w"] = _rel_max(warm.coefficients, cold.coefficients)
            ok = res["warm_vs_cold_rel_max_w"] <= 1e-4
        else:
            res["cold_bitwise_plain_fit"] = (cold.weights.tobytes() == plain.weights.tobytes()
                                             and cold.intercepts.tobytes() == plain.intercepts.tobytes()
                                             and cold.numIter == plain.numIter)
            sigma = f64_stddev(x_b)
            f_warm = logistic_objective64(x_b, yb, warm.weights, warm.intercepts, 0.01, sigma)
            f_cold = logistic_objective64(x_b, yb, cold.weights, cold.intercepts, 0.01, sigma)
            res.update(objective_warm=f_warm, objective_cold=f_cold, num_iter=[warm.numIter, cold.numIter],
                       objective_rel=abs(f_warm - f_cold) / abs(f_cold))
            ok = res["objective_rel"] <= 1e-4
        out[name] = res
        del ya, yb
        require(0 < warm_iters < cold_iters, f"(g-c) {name}: warm {warm_iters} iterations, cold {cold_iters}")
        require(res["cold_bitwise_plain_fit"], f"(g-c) {name}: the cold partial_fit differs from a plain fit")
        require(ok, f"(g-c) {name}: warm against cold {res}")
    emit(out)
    return out


@contextlib.contextmanager
def stage_clock(marks: list):
    """Record when each journal stage commits (the controller's stage
    walls are the gaps between commits)."""
    from spark_rapids_ml_tpu_torch.lifecycle.journal import CycleJournal

    real = CycleJournal.mark

    def timed(self, stage, payload=None):
        real(self, stage, payload)
        marks.append((stage, time.perf_counter()))

    CycleJournal.mark = timed
    try:
        yield marks
    finally:
        CycleJournal.mark = real


def _timed_cycle(ctrl, x) -> tuple:
    marks = []
    with stage_clock(marks):
        t0 = time.perf_counter()
        outcome = ctrl.run_cycle(x)
        wall = time.perf_counter() - t0
    walls, last = {}, t0
    for stage, t in marks:
        walls[stage] = t - last
        last = t
    walls["after_flip"] = t0 + wall - last
    return outcome, {"wall_s": wall, "stage_walls_s": walls}


class _Traffic:
    """Single-row requests on a thread of their own while a cycle runs:
    every response's version, and every shed or failed request."""

    def __init__(self, rt, rows: np.ndarray):
        self.rt, self.rows = rt, rows
        self.versions, self.errors = [], []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        i = 0
        while not self.stop.is_set():
            try:
                fut = self.rt.submit("km@prod", self.rows[i % len(self.rows)])
                label = int(np.asarray(fut.result(timeout=30)).reshape(-1)[0])
                self.versions.append((fut.model_name, fut.model_version, 0 <= label < KM_K))
            except Exception as exc:  # every failure is counted and fails the phase
                self.errors.append(repr(exc))
            i += 1

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        time.sleep(0.05)
        self.stop.set()
        self.thread.join(timeout=60)


def _serve_window(rt, dm, rows: np.ndarray, centres: dict) -> set:
    """Serve ``rows`` one at a time and feed the monitor each row's
    distance to the nearest centre of the version that answered."""
    versions = set()
    for row in rows:
        fut = rt.submit("km@prod", row)
        fut.result(timeout=30)
        v = fut.model_version
        versions.add(v)
        if v not in centres:
            centres[v] = np.asarray(rt.registry.resolve("km", v).model.clusterCenters(), dtype=np.float64)
        dm.observe(float(np.linalg.norm(centres[v] - row, axis=1).min()))
    return versions


def phase_lifecycle_controller(truth: torch.Tensor, incumbent, tmp: str) -> dict:
    """(g-d) A ``LifecycleController`` over a started ``ServingRuntime`` at
    config 3's width, the incumbent from (b) as version 1. A
    ``DriftMonitor`` fed from served distances stays quiet on the blobs and
    fires on the shifted blobs; a cycle on 2,000,000 shifted rows flips to
    version 2 while single rows keep flowing (every response attributed,
    none shed); a cycle with a prohibitive ``gate_margin`` is rejected and
    version 2 keeps serving; ``watch`` with a regressed score rolls back to
    version 1."""
    from spark_rapids_ml_tpu_torch.lifecycle import DriftMonitor, LifecycleController
    from spark_rapids_ml_tpu_torch.serving import ServingRuntime

    shifted = truth + LC_SHIFT
    plain_rows = blob_rows(3 * LC_WINDOW, truth, lc_generator(6)).double().cpu().numpy()
    shifted_rows = blob_rows(2 * LC_WINDOW, shifted, lc_generator(7)).double().cpu().numpy()
    out = {"phase": "lifecycle_controller", "cycle_rows": LC_CYCLE_N}
    with ServingRuntime() as rt:
        rt.register("km", incumbent, alias="prod", warm_buckets=(1,))
        ctrl = LifecycleController(lc_kmeans(), rt, "km", score_fn=lc_score,
                                   directory=os.path.join(tmp, "controller"), model=incumbent)
        dm = DriftMonitor("km", threshold=0.25, min_count=LC_WINDOW)
        centres = {}
        ticks = []
        for rows in (plain_rows[:LC_WINDOW], plain_rows[LC_WINDOW:2 * LC_WINDOW], shifted_rows[:LC_WINDOW]):
            t0 = time.perf_counter()
            served = _serve_window(rt, dm, rows, centres)
            ticks.append({"versions": sorted(served), "psi": dm.tick(), "window_s": time.perf_counter() - t0})
        out["drift_ticks"] = ticks
        x_cycle = blob_rows(LC_CYCLE_N, shifted, lc_generator(8)).cpu().numpy()
        with _Traffic(rt, shifted_rows[LC_WINDOW:]) as traffic:
            flip, out["flip_cycle"] = _timed_cycle(ctrl, x_cycle)
            time.sleep(0.2)
        dm.rebaseline()
        out["flip_cycle"].update(outcome=vars(flip).copy(), data_npz_bytes=os.path.getsize(
            os.path.join(tmp, "controller", f"cycle_{flip.cycle}_data.npz")))
        versions = [v for _, v, _ in traffic.versions]
        out["traffic"] = {"requests": len(traffic.versions), "errors": traffic.errors[:5],
                          "by_version": {str(v): versions.count(v) for v in sorted(set(versions))},
                          "attributed": all(n == "km" and v in (1, 2) and ok for n, v, ok in traffic.versions),
                          "last_version": versions[-1] if versions else None}
        ctrl.gate_margin = 1e9
        x_reject = blob_rows(LC_CYCLE_N, shifted, lc_generator(9)).cpu().numpy()
        reject, out["rejected_cycle"] = _timed_cycle(ctrl, x_reject)
        out["rejected_cycle"]["outcome"] = vars(reject).copy()
        after_reject = rt.submit("km@prod", shifted_rows[0])
        after_reject.result(timeout=30)
        rolled = ctrl.watch(flip.candidate_score - 10.0 * abs(flip.candidate_score))
        after_rollback = rt.submit("km@prod", shifted_rows[0])
        after_rollback.result(timeout=30)
        out["rollback"] = {"to": rolled, "aliases": rt.registry.aliases("km"),
                           "served_after_reject": after_reject.model_version,
                           "served_after_rollback": after_rollback.model_version,
                           "versions": rt.registry.versions("km")}
    emit(out)
    require([t["psi"] is None for t in ticks] == [True, True, False] and ticks[2]["psi"] > 0.25,
            f"(g-d) drift ticks: {ticks}")
    require(flip.action == "flipped" and flip.version == 2 and flip.cycle == 0,
            f"(g-d) the drifted cycle: {flip}")
    require(out["traffic"]["attributed"] and not traffic.errors and out["traffic"]["requests"] > 0
            and out["traffic"]["last_version"] == 2, f"(g-d) traffic through the flip: {out['traffic']}")
    require(reject.action == "rejected" and reject.version is None and out["rollback"]["served_after_reject"] == 2,
            f"(g-d) the gated cycle: {reject}, {out['rollback']}")
    require(rolled == 1 and out["rollback"]["aliases"] == {"prod": 1} and out["rollback"]["served_after_rollback"] == 1
            and out["rollback"]["versions"] == [1, 2], f"(g-d) the rollback: {out['rollback']}")
    return out


def lifecycle_child_main(argv) -> int:
    """(g-e)'s child: a controller over (d)'s shape whose cycle is killed in
    its refit stage (``LC_KILL_SPEC``); it SIGKILLs itself there."""
    from spark_rapids_ml_tpu_torch.lifecycle import LifecycleController
    from spark_rapids_ml_tpu_torch.robustness import InjectedFault, inject
    from spark_rapids_ml_tpu_torch.serving import ServingRuntime

    directory, incumbent_path = argv[argv.index("--lifecycle-child") + 1:][:2]
    port_device.set_platform("cuda")
    port_device.use_ieee_fp32_matmul()
    with open(incumbent_path, "rb") as f:
        incumbent = pickle.load(f)
    ctrl = LifecycleController(lc_kmeans(), ServingRuntime(), "km", score_fn=lc_score,
                               directory=directory, model=incumbent)
    x = lc_cycle_rows(lc_truth())
    with inject(LC_KILL_SPEC):
        try:
            ctrl.run_cycle(x)
        except InjectedFault:
            with open(os.path.join(directory, "cycle.json")) as f:
                print("lifecycle child stages " + json.dumps(sorted(json.load(f)["stages"])), flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
    print("lifecycle child completed", flush=True)
    return 0


def phase_lifecycle_kill(truth: torch.Tensor, incumbent, tmp: str) -> dict:
    """(g-e) A child controller (``--lifecycle-child``) SIGKILLs itself in
    its refit stage at (d)'s shape; the parent rebuilds the runtime and
    resumes the SAME cycle id: the registry holds exactly one version, and
    the incumbent's centres are bitwise those of an uninterrupted cycle on
    the same rows (the candidate pickled by plain ``pickle`` on the way)."""
    from spark_rapids_ml_tpu_torch.lifecycle import LifecycleController
    from spark_rapids_ml_tpu_torch.serving import ServingRuntime

    incumbent_path = os.path.join(tmp, "incumbent_b.pkl")
    with open(incumbent_path, "wb") as f:
        pickle.dump(incumbent, f, protocol=pickle.HIGHEST_PROTOCOL)
    killed_dir = os.path.join(tmp, "killed")
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUML_")}
    env["TPUML_RETRY_BASE_DELAY"] = "0"
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--lifecycle-child", killed_dir,
                              incumbent_path], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        stdout, stderr = child.communicate(timeout=LC_CHILD_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    child_s = time.perf_counter() - t0
    x = lc_cycle_rows(truth)
    with ServingRuntime() as rt:
        ctrl = LifecycleController(lc_kmeans(), rt, "km", score_fn=lc_score,
                                   directory=killed_dir, model=incumbent)
        clear_counters("lifecycle")
        resumed, timing = _timed_cycle(ctrl, x)
        replayed = counter_value("lifecycle.stage.replayed")
        versions = rt.registry.versions("km")
        got = ctrl.model.clusterCenters()
    with ServingRuntime() as rt:
        ref = LifecycleController(lc_kmeans(), rt, "km", score_fn=lc_score,
                                  directory=os.path.join(tmp, "uninterrupted"), model=incumbent)
        clean, clean_timing = _timed_cycle(ref, x)
        want = ref.model.clusterCenters()
    out = {"phase": "lifecycle_kill", "spec": LC_KILL_SPEC, "child_returncode": child.returncode,
           "child_s": child_s, "child_stdout": stdout.strip().splitlines()[-1:],
           "resumed": {"outcome": vars(resumed).copy(), "stages_replayed": replayed, **timing},
           "uninterrupted": {"outcome": vars(clean).copy(), **clean_timing},
           "registry_versions": versions, "incumbent_bitwise_uninterrupted": got.tobytes() == want.tobytes()}
    emit(out)
    require(child.returncode == -signal.SIGKILL and 'lifecycle child stages ["ingest"]' in stdout,
            f"(g-e) the child was not killed in its refit: {out}; {stderr[-2000:]}")
    require(resumed.cycle == clean.cycle == 0 and resumed.action == clean.action == "flipped"
            and replayed == 1 and versions == [1], f"(g-e) the resumed cycle: {out}")
    require(out["incumbent_bitwise_uninterrupted"], "(g-e) the resumed cycle's centres differ")
    return out


def lifecycle_phases() -> dict:
    """Group (g), the continuous-training lifecycle: (a) PCA partial_fit at
    config 5's width through K1's float64 route, (b) config 3's warm and
    cold refits after a K2 fit, (c) configs 4 and 10's warm and cold
    refits, (d) the journaled controller over a started runtime with a
    drift monitor, (e) a SIGKILLed controller resumed; its own seeds,
    within ``LC_WALL_LIMIT_S``."""
    t0 = time.perf_counter()
    walls = {}
    with tempfile.TemporaryDirectory(prefix="lifecycle-") as tmp, knob(TPUML_RETRY_BASE_DELAY=0):
        t = time.perf_counter()
        a = phase_lifecycle_pca()
        walls["a_pca"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        truth = lc_truth()
        t = time.perf_counter()
        b = phase_lifecycle_kmeans(truth)
        walls["b_kmeans"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        c = phase_lifecycle_glm()
        walls["c_glm"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        d = phase_lifecycle_controller(truth, b["incumbent"], tmp)
        walls["d_controller"] = time.perf_counter() - t
        t = time.perf_counter()
        e = phase_lifecycle_kill(truth, b["incumbent"], tmp)
        walls["e_kill"] = time.perf_counter() - t
    wall = time.perf_counter() - t0
    emit({"phases": "lifecycle", "wall_s": wall, "phase_wall_s": walls})
    require(wall <= LC_WALL_LIMIT_S, f"the lifecycle phases took {wall:.1f} s, over their {LC_WALL_LIMIT_S:.0f} s")
    return {"pca": a, "kmeans": b["out"], "glm": c, "controller": d, "kill": e}


# --- observability: traces and probes on the card ---------------------------

OB_SEED = 19
OB_WALL_LIMIT_S = 60.0
OB_GANG_N = 262_144          # (c): rows a rank, config 5's width
OB_HEARTBEAT_S = 0.2         # (c): the ranks' heartbeat interval
OB_RANK_TIMEOUT_S = 60
OB_CHILD_TIMEOUT_S = 45
OB_CHILD_ROWS = 65_536       # (e): the fatal child's host PCA rows (x 128)
OB_RANGES = 10_000           # (f): ranges timed in each state
OB_SLO_BREACH = "serving.p99_ms<=0.001"
OB_SLO_HOLD = "serving.p99_ms<=10000"


def _obs_records(tdir: str) -> list:
    return [json.loads(line) for path in sorted(glob.glob(os.path.join(tdir, "events-*.jsonl")))
            for line in open(path) if line.strip()]


@contextlib.contextmanager
def telemetry_dir(path: str):
    """``TPUML_TELEMETRY_DIR`` set and the port's sink wired to its shard
    for the block; the sink is off again after."""
    from spark_rapids_ml_tpu_torch.observability import events

    with knob(TPUML_TELEMETRY_DIR=path):
        events.configure()
        try:
            yield path
        finally:
            events.flush_telemetry()
    events.configure("")


def _range_device_span_ms(prof, names) -> dict:
    """Each named range's extent on the device's timeline: its
    ``record_function`` annotation there, from its first kernel to its
    last, idle gaps included (a kernel launched through ``ctypes``, as
    K1 is, is charged to no host-side op, but lies inside the span)."""
    out = {}
    for avg in prof.key_averages():
        if avg.key in names and _is_annotation(avg):
            out[avg.key] = out.get(avg.key, 0.0) + avg.self_device_time_total / 1e3
    return out


def phase_obs_pca(gen: torch.Generator, tmp: str) -> dict:
    """(a) Config 5's width: ``PCA().setK(16)`` on the ``pallas`` route over
    a 1,048,576 x 1,024 float32 tensor, untraced and under
    ``TPUML_TELEMETRY_DIR``: the report's stages and device memory, K1
    launched as in the untraced fit, components and ratios bitwise, walls
    (median of 3) each way, and one traced fit under ``torch.profiler`` for
    its stage totals (host time) beside its device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_ml_tpu_torch.observability import events

    x = planted(MS_N, D, gen)
    est = PCA().setK(K).setCovarianceBackend("pallas")
    est.fit(x)
    sync()
    k1.reset_launches()
    plain = est.fit(x)
    plain_launches = k1.launches
    untraced_wall = wall_s(lambda: est.fit(x).pc)
    tdir = os.path.join(tmp, "a-telemetry")
    with telemetry_dir(tdir):
        torch.cuda.reset_peak_memory_stats()
        k1.reset_launches()
        traced = est.fit(x)
        traced_launches = k1.launches
        traced_wall = wall_s(lambda: est.fit(x).pc)
        k1.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # One small kernel and a sync first, so the fit's first kernels
            # do not fall in the session's start-up.
            torch.ones(1, device=x.device).add_(1.0)
            sync()
            profiled = est.fit(x)
            sync()
        profiled_launches = k1.launches
    rep = traced.fit_report()
    stages = rep.stage_totals()
    prof_stages = profiled.fit_report().stage_totals()
    recs = _obs_records(tdir)
    problems = [p for r in recs for p in events.validate_record(r)]
    mem = rep.device_memory.get(str(torch.cuda.current_device()), {})
    top = sorted(_device_ms_by_kernel(prof).items(), key=lambda kv: -kv[1])[:8]
    out = {
        "phase": "obs_pca", "what": "PCA().setK(16).setCovarianceBackend('pallas'), 1,048,576 x 1,024 f32",
        "k1_launches": {"untraced": plain_launches, "traced": traced_launches, "profiled": profiled_launches},
        "bitwise": {"pc": bool(np.array_equal(traced.pc, plain.pc)),
                    "ratio": bool(np.array_equal(traced.explainedVariance, plain.explainedVariance))},
        "fit_wall_s_median_of_3": {"untraced": untraced_wall, "traced": traced_wall},
        "stage_tree": [n["name"] for n in rep.stage_tree()],
        "stage_totals_host_ms": {k: v["seconds"] * 1e3 for k, v in stages.items()},
        "profiled_fit": {
            "stage_totals_host_ms": {k: v["seconds"] * 1e3 for k, v in prof_stages.items()},
            "stage_device_span_ms": _range_device_span_ms(prof, set(prof_stages)),
            "top_device_ms": [{"kernel": k[:80], "ms": v} for k, v in top],
        },
        "device_memory": mem, "tensor_bytes": x.numel() * x.element_size(),
        "shard_records": len(recs), "span_records": sum(r["event"] == "span" for r in recs),
        "invalid_records": problems[:5],
    }
    emit(out)
    require(plain_launches == traced_launches == 1, f"(o-a) K1 launches {out['k1_launches']}")
    require(all(out["bitwise"].values()), f"(o-a) the traced fit differs: {out['bitwise']}")
    require({"compute cov", "auto eigh"} <= set(stages), f"(o-a) the report's stages: {sorted(stages)}")
    require(mem.get("peak_bytes_in_use", 0) >= out["tensor_bytes"], f"(o-a) device memory {mem}")
    require(not problems and out["span_records"] > 0 and any(r["event"] == "report" for r in recs),
            f"(o-a) the shard: {problems[:5]}")
    return out


def phase_obs_kmeans(gen: torch.Generator, tmp: str) -> dict:
    """(b) Config 3 under ``TPUML_PROFILE_DIR``: ``KMeans().setK(100)
    .setSeed(0)`` on 20M x 16 float32 blobs writes one Chrome trace that
    parses and holds K2's kernel by its symbol and the port's range names;
    K2 launches as in the same untraced fit, with the same centres; a
    nested ``maybe_profile`` yields None."""
    from spark_rapids_ml_tpu_torch.observability import profiling

    x, _ = planted_blobs(KM_N, KM_D, KM_K, gen)
    est = KMeans().setK(KM_K).setSeed(0)
    kk.reset_launches()
    plain = est.fit(x)
    plain_launches = kk.launches["assign_stats_fused"]
    pdir = os.path.join(tmp, "b-profile")
    with knob(TPUML_PROFILE_DIR=pdir):
        kk.reset_launches()
        t0 = time.perf_counter()
        traced = est.fit(x)
        traced_launches = kk.launches["assign_stats_fused"]
        wall = time.perf_counter() - t0
        with profiling.maybe_profile("obs-outer") as outer, profiling.maybe_profile("obs-inner") as inner:
            pass
    traces = sorted(glob.glob(os.path.join(pdir, "fit_KMeans-*.trace.json")))
    doc = json.load(open(traces[0])) if len(traces) == 1 else {"traceEvents": []}
    names = {e.get("name", "") for e in doc["traceEvents"]}
    k2 = sorted({n for n in names if "assign_stats_" in n})
    ranges = sorted(n for n in names if n.startswith("kmeans") or n.startswith("ingest"))
    out = {
        "phase": "obs_kmeans", "what": "KMeans().setK(100).setSeed(0), 20M x 16 f32, TPUML_PROFILE_DIR",
        "k2_launches": {"untraced": plain_launches, "profiled": traced_launches},
        "centres_bitwise": bool(np.array_equal(traced.clusterCenters(), plain.clusterCenters())),
        "profiled_fit_wall_s": wall, "trace_files": [os.path.basename(t) for t in traces],
        "trace_bytes": os.path.getsize(traces[0]) if traces else 0, "trace_events": len(doc["traceEvents"]),
        "k2_symbols": [n[:120] for n in k2], "range_names": ranges,
        "nested": {"outer": outer is not None, "inner": inner},
    }
    emit(out)
    require(len(traces) == 1, f"(o-b) trace files {traces}")
    require(plain_launches == traced_launches >= 1, f"(o-b) K2 launches {out['k2_launches']}")
    require(out["centres_bitwise"], "(o-b) the profiled fit's centres differ")
    require(bool(k2) and "kmeans fit" in names, f"(o-b) the trace lacks K2 or the ranges: {k2} {ranges}")
    require(outer is not None and inner is None, f"(o-b) nested maybe_profile: {out['nested']}")
    return out


def obs_rank_main(argv) -> int:
    """One rank of (o-c), started by :func:`phase_obs_gang` with
    ``member_env`` (the trace carrier) and ``TPUML_TELEMETRY_DIR``: joins
    the gloo gang on the one card and fits gang PCA on its 262,144 x 1,024
    rows inside ``heartbeat_scope``."""
    from spark_rapids_ml_tpu_torch.observability.heartbeat import heartbeat_scope

    args = dict(zip(argv[1::2], argv[2::2]))
    rank = int(args["--obs-rank"])
    port_device.set_platform("cuda")
    port_device.use_ieee_fp32_matmul()
    gang.initialize(coordinator_address=f"127.0.0.1:{args['--obs-port']}", backend="gloo")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(OB_SEED + rank)
    x = planted(OB_GANG_N, D, gen)
    with heartbeat_scope(process_id=rank, interval=OB_HEARTBEAT_S):
        model = PCA().setDeployMode("gang").setK(K).fit(x)
    np.savez(os.path.join(args["--obs-out"], f"obs-rank{rank}.npz"), pc=model.pc, ev=model.explainedVariance)
    torch.distributed.destroy_process_group()
    print(f"obs rank {rank} ok", flush=True)
    return 0


def phase_obs_gang(tmp: str) -> dict:
    """(c) Two gloo ranks on the one card, spawned with ``member_env`` inside
    one run scope and sharded under one telemetry dir: the port's
    ``trace.assemble`` gives one trace with both process indices,
    heartbeats from both ranks and a critical path; its Chrome trace loads;
    the ranks' components are bitwise equal."""
    from spark_rapids_ml_tpu_torch.observability import events, trace

    tdir = os.path.join(tmp, "c-telemetry")
    with contextlib.closing(__import__("socket").socket()) as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = {**os.environ, "TPUML_TELEMETRY_DIR": tdir}
    with events.run_scope("job", "obs-gang"):
        trace_id = events.current_trace().trace_id
        envs = [gang.member_env(rank, 2, base=base) for rank in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--obs-rank", str(rank),
                               "--obs-port", str(port), "--obs-out", tmp],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank, env in enumerate(envs)]
    try:
        outs = [p.communicate(timeout=OB_RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        require(p.returncode == 0 and f"obs rank {rank} ok" in stdout, f"(o-c) rank {rank}: {stderr[-2000:]}")
    ranks = [np.load(os.path.join(tmp, f"obs-rank{r}.npz")) for r in range(2)]
    t1 = time.perf_counter()
    merged = trace.assemble(tdir)
    assemble_s = time.perf_counter() - t1
    chrome = json.loads(json.dumps(trace.chrome_trace(merged["records"])))
    beats = sorted({r["process"] for r in merged["records"] if r["event"] == "heartbeat"})
    cells = list(merged["traces"].values())
    out = {
        "phase": "obs_gang", "ranks": 2, "rows_per_rank": OB_GANG_N, "wall_s": wall, "assemble_s": assemble_s,
        "records": merged["record_count"], "manifests": len(merged["manifests"]),
        "traces": [{k: c[k] for k in ("trace_id", "spans", "events", "roots", "processes")} for c in cells],
        "critical_path": [s["name"] for s in cells[0]["critical_path"]] if cells else [],
        "heartbeat_processes": beats, "chrome_span_events": sum(e.get("ph") == "X" for e in chrome["traceEvents"]),
        "problems": (merged["problems"] + merged["orphan_problems"])[:5],
        "bitwise": bool(np.array_equal(ranks[0]["pc"], ranks[1]["pc"])
                        and np.array_equal(ranks[0]["ev"], ranks[1]["ev"])),
    }
    emit(out)
    require(not out["problems"] and out["manifests"] == 2, f"(o-c) the merge: {out['problems']}")
    require(len(cells) == 1 and cells[0]["trace_id"] == trace_id and cells[0]["processes"] == [0, 1],
            f"(o-c) traces {out['traces']}")
    require(beats == [0, 1] and out["critical_path"] and out["chrome_span_events"] > 0, f"(o-c) {out}")
    require(out["bitwise"], "(o-c) the ranks' components differ")
    return out


def phase_obs_slo(gen: torch.Generator, tmp: str) -> dict:
    """(d) Config 16's model behind the in-process ``ServingRuntime``
    (16 closed-loop threads x 150 single rows, batched 16 / 5 ms), with
    ``TPUML_SLO`` first a p99 objective the burst must breach, then one
    that holds: the breach reaches a subscribed ``DriftMonitor`` as one
    vote, the recover record after an idle window is no vote. The same
    loop runs once more with a telemetry sink on, for what recording
    costs a request."""
    from spark_rapids_ml_tpu_torch.lifecycle.drift import DriftMonitor
    from spark_rapids_ml_tpu_torch.observability import slo
    from spark_rapids_ml_tpu_torch.observability.metrics import gauge
    from spark_rapids_ml_tpu_torch.serving import ServingRuntime

    dev = gen.device
    c64 = torch.randn((KM_K, KM_D), generator=gen, device=dev, dtype=torch.float64) * KM_SCALE
    model = KMeansModel("obs16", c64.cpu().numpy())
    total = SV_THREADS * SV_REQUESTS
    rows = c64[torch.randint(0, KM_K, (total,), generator=gen, device=dev)]
    probes = (rows + 4.0 * torch.randn(rows.shape, generator=gen, device=dev, dtype=torch.float64)) \
        .cpu().numpy().reshape(SV_THREADS, SV_REQUESTS, KM_D)

    def burst(monitor=None) -> dict:
        rt = ServingRuntime(max_batch=SV_THREADS, max_delay_ms=5.0, queue_limit=4 * total)
        rt.register("km", model)
        rt.warm("km", buckets=[1 << p for p in range(5)])
        if monitor is not None:
            monitor.tick()  # absorb the history before the burst
        wall, _, lat = _closed_loop(rt, probes)
        rt.close()
        cell = monitor.tick()["serving.p99_ms"] if monitor is not None else None
        return {"rows_per_s": total / wall, "p99_ms": float(np.percentile(lat, 99)), "slo": cell}

    votes, edges = [], []
    try:
        with knob(TPUML_SLO=OB_SLO_BREACH):
            mon = slo.SloMonitor()
            dm = DriftMonitor("obs16", threshold=10.0, min_count=50)
            mon.subscribe(dm.on_slo_breach)
            mon.subscribe(edges.append)
            breach = burst(mon)
            votes.append(dm._slo_votes)
            recover = mon.tick()["serving.p99_ms"]  # an idle window
            votes.append(dm._slo_votes)
        with knob(TPUML_SLO=OB_SLO_HOLD):
            hold = burst(slo.SloMonitor())
    finally:
        gauge(slo.BURN_GAUGE).remove(objective="serving.p99_ms")
    with telemetry_dir(os.path.join(tmp, "d-telemetry")):
        recorded = burst()
    out = {
        "phase": "obs_slo", "model": [KM_K, KM_D], "threads": SV_THREADS, "requests": total,
        "breach": breach, "edges": [e["action"] for e in edges], "votes_after_breach_and_recover": votes,
        "recover": recover, "hold": hold, "with_telemetry_sink": recorded,
        "sink_over_no_sink_rows_s": recorded["rows_per_s"] / hold["rows_per_s"],
        "timing": "host clock, closed loop",
    }
    emit(out)
    require(breach["slo"]["breached"] and breach["slo"]["window"] >= total, f"(o-d) no breach: {breach}")
    require(out["edges"] == ["breach", "recover"] and votes == [1, 1], f"(o-d) edges {out['edges']}, votes {votes}")
    require(not hold["slo"]["breached"] and hold["slo"]["window"] >= total, f"(o-d) the holding SLO: {hold}")
    return out


def obs_child_main(argv) -> int:
    """(o-e)'s children: ``fatal`` dies of an injected fatal fault in a host
    PCA fit; ``sigterm`` waits, with the SIGTERM flush installed, for the
    parent's signal; ``clean`` bumps a counter and exits."""
    from spark_rapids_ml_tpu_torch.observability import events
    from spark_rapids_ml_tpu_torch.utils.tracing import TraceRange, bump_counter

    kind = argv[argv.index("--obs-child") + 1]
    if kind == "fatal":
        port_device.set_platform("cuda")
        x = np.random.default_rng(OB_SEED).standard_normal((OB_CHILD_ROWS, 128))
        PCA().setK(K).fit(x)  # TPUML_FAULTS kills it
        return 0
    port_device.set_platform("cpu")
    bump_counter("obs.child.counter", 3)
    if kind == "sigterm":
        events.install_sigterm_flush()
        with events.run_scope("job", "obs-sigterm"), TraceRange("waiting for SIGTERM"):
            print("obs child ready", flush=True)
            time.sleep(OB_CHILD_TIMEOUT_S)
    return 0


def start_obs_children(tmp: str) -> dict:
    """(e)'s three children, started together (they run while (c)'s ranks
    do): ``fatal`` with ``TPUML_FLIGHT=256``, ``TPUML_FLIGHT_DIR`` and a
    fatal ``ingest.device_put`` fault; ``sigterm`` with a telemetry dir;
    ``clean`` with ``TPUML_METRICS_DUMP``. The working directory of each is
    ``tmp``, where no dump may land."""
    clean_env = {k: v for k, v in os.environ.items() if not k.startswith("TPUML_")}
    paths = {"flight": os.path.join(tmp, "e-flight"), "telemetry": os.path.join(tmp, "e-telemetry"),
             "dump": os.path.join(tmp, "e-clean.prom")}
    envs = {
        "fatal": {**clean_env, "TPUML_FLIGHT": "256", "TPUML_FLIGHT_DIR": paths["flight"],
                  "TPUML_FAULTS": "ingest.device_put=1:fatal"},
        "sigterm": {**clean_env, "TPUML_FLIGHT": "256", "TPUML_TELEMETRY_DIR": paths["telemetry"]},
        "clean": {**clean_env, "TPUML_METRICS_DUMP": paths["dump"]},
    }
    procs = {kind: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--obs-child", kind], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=tmp)
             for kind, env in envs.items()}
    return {"procs": procs, "paths": paths, "t0": time.perf_counter()}


def phase_obs_children(tmp: str, started: dict) -> dict:
    """(e) The children of :func:`start_obs_children`: the fatal one leaves
    ``flight-<pid>.json`` holding the fault record; the SIGTERMed one its
    manifest and flight dump in its telemetry dir; the clean one its
    ``TPUML_METRICS_DUMP``. Then the exposition of this process's registry
    parses back to its values."""
    from spark_rapids_ml_tpu_torch.observability import metrics

    procs, paths, t0 = started["procs"], started["paths"], started["t0"]
    fdir, tdir, dump = paths["flight"], paths["telemetry"], paths["dump"]
    try:
        term = procs["sigterm"]
        ready = term.stdout.readline()
        if "ready" in ready:
            term.send_signal(signal.SIGTERM)
        outs = {kind: p.communicate(timeout=OB_CHILD_TIMEOUT_S) for kind, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    codes = {kind: p.returncode for kind, p in procs.items()}
    fatal_dumps = glob.glob(os.path.join(fdir, "flight-*.json"))
    fatal = json.load(open(fatal_dumps[0])) if len(fatal_dumps) == 1 else {}
    fires = [r for r in fatal.get("ring", []) if r.get("event") == "fault" and r.get("action") == "fire"]
    tpid = term.pid
    term_files = sorted(os.path.basename(f) for f in glob.glob(os.path.join(tdir, "*")))
    term_flight = os.path.join(tdir, f"flight-{tpid}.json")
    parsed = metrics.parse_exposition(open(dump).read()) if os.path.exists(dump) else {}
    metrics.counter("obs.exposition.check").inc(2)
    metrics.counter("obs.exposition.check").inc(5, site="a b")
    snap = metrics.default_registry.snapshot()
    text = metrics.parse_exposition(metrics.default_registry.render_prometheus())
    mismatched = []
    for series, v in snap["counters"].items():
        base, brace, labels = series.partition("{")
        name = metrics._prom_name(base)
        if text.get(name, {}).get("series", {}).get(name + brace + labels) != float(v):
            mismatched.append(series)
    out = {
        "phase": "obs_children", "wall_s": wall, "returncodes": codes, "ready_line": ready.strip(),
        "fatal": {"dumps": [os.path.basename(f) for f in fatal_dumps], "reason": fatal.get("reason"),
                  "detail": fatal.get("detail"), "fault_fires": [r.get("site") for r in fires],
                  "stray_dumps_in_cwd": sorted(os.path.basename(f) for f in glob.glob(os.path.join(tmp, "flight-*")))},
        "sigterm": {"files": term_files,
                    "flight_reason": json.load(open(term_flight)).get("reason") if os.path.exists(term_flight) else None},
        "clean": {"dump_series": parsed.get("tpuml_obs_child_counter", {}).get("series")},
        "exposition_round_trip": {"counters": len(snap["counters"]), "mismatched": mismatched[:5]},
    }
    emit(out)
    require(codes["fatal"] == 1 and fatal.get("reason") == "fatal" and fires
            and fires[0].get("site") == "ingest.device_put", f"(o-e) the fatal child: {out['fatal']}; "
            f"{outs['fatal'][1][-1500:]}")
    require(not out["fatal"]["stray_dumps_in_cwd"], "(o-e) a dump landed in the working directory")
    require(codes["sigterm"] == 143 and f"manifest-{tpid}.json" in term_files
            and out["sigterm"]["flight_reason"] == "sigterm", f"(o-e) the SIGTERMed child: {out['sigterm']}; "
            f"{outs['sigterm'][1][-1500:]}")
    require(codes["clean"] == 0 and out["clean"]["dump_series"] == {"tpuml_obs_child_counter": 3.0},
            f"(o-e) the clean child's dump: {out['clean']}")
    require(not mismatched and snap["counters"], f"(o-e) the exposition round trip: {mismatched[:5]}")
    return out


def phase_obs_range_cost() -> dict:
    """(f) One ``TraceRange`` enter + exit, median of 10,000 on this host,
    in three states: no sink and no run scope, under a run scope (a span
    record into the run), and with a telemetry sink (a span record written
    to the shard); beside an empty pair of clock reads."""
    from spark_rapids_ml_tpu_torch.observability import events
    from spark_rapids_ml_tpu_torch.utils.tracing import TraceRange

    def median_us(body) -> float:
        samples = []
        for _ in range(OB_RANGES):
            t0 = time.perf_counter_ns()
            body()
            samples.append(time.perf_counter_ns() - t0)
        return statistics.median(samples) / 1e3

    def one_range():
        with TraceRange("obs range cost"):
            pass

    events.configure("")
    out = {"phase": "obs_range_cost", "ranges": OB_RANGES, "clock_pair_us": median_us(lambda: None),
           "off_us": median_us(one_range)}
    with events.run_scope("job", "range-cost"):
        out["run_scope_us"] = median_us(one_range)
    with tempfile.TemporaryDirectory() as tdir, telemetry_dir(tdir):
        out["telemetry_sink_us"] = median_us(one_range)
    out["timing"] = "host clock (perf_counter_ns) around enter + exit, median"
    emit(out)
    require(out["off_us"] < out["telemetry_sink_us"], f"(o-f) {out}")
    return out


def observability_phases(card: str) -> dict:
    """Group (o), traces and probes: (a) a traced config-5 PCA fit bitwise
    an untraced one, (b) config 3 under ``TPUML_PROFILE_DIR``, (c) a 2-rank
    gang's merged trace, (d) SLO votes over config 16's runtime, (e) flight
    dumps, a SIGTERM flush and a metrics dump, (f) a range's cost; its own
    seed, within ``OB_WALL_LIMIT_S``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(OB_SEED)
    t0 = time.perf_counter()
    walls = {}
    with tempfile.TemporaryDirectory(prefix="obs-") as tmp:
        def gang_and_children():
            # (e)'s children start with (c)'s ranks: both wait mostly on
            # interpreters and CUDA contexts coming up.
            started = start_obs_children(tmp)
            try:
                phase_obs_gang(tmp)
            except BaseException:
                for p in started["procs"].values():
                    p.kill()
                    p.wait()
                raise
            phase_obs_children(tmp, started)

        for name, run in (("a_pca", lambda: phase_obs_pca(gen, tmp)),
                          ("b_kmeans", lambda: phase_obs_kmeans(gen, tmp)),
                          ("c_gang_and_e_children", gang_and_children),
                          ("d_slo", lambda: phase_obs_slo(gen, tmp)),
                          ("f_range_cost", phase_obs_range_cost)):
            t = time.perf_counter()
            run()
            walls[name] = time.perf_counter() - t
            torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    emit({"phases": "observability", "card": card, "wall_s": wall, "phase_wall_s": walls})
    require(wall <= OB_WALL_LIMIT_S, f"the observability phases took {wall:.1f} s, over their {OB_WALL_LIMIT_S:.0f} s")
    return walls


# ---------------------------------------------------------------------------
# group (p): the cost ledger and the autotuner
# ---------------------------------------------------------------------------

CO_SEED = SEED + 700
CO_WALL_LIMIT_S = 60.0
#: The peaks the kernel table's bound column uses for this card (PERF.md
#: §6): fp32 67 TFLOP/s outside the tensor cores, HBM 3.35 TB/s.
CO_PEAK_FLOPS = 67e12
CO_PEAK_BYTES = 3.35e12
CO_TRANSFORM_SIZES = (3, 100, 4_097)   # (a): transforms through the program cache
CO_HOST_CALLS = 50                     # (a): host enqueue time, median of this many calls
CO_WANDER = (5, 40, 300, 5, 40, 300, 5, 40)  # (b): a wandering batch size on a cache of two
CO_BYPASS_ROWS = (16, 12, 11, 10)      # (b): rows forced inside the 16-row bucket
CO_REPLAY_ROWS = 100                   # (b): the replay timed with the ledger off and on
CO_HOT_N = 12                          # (c): a hot batch size that is no power of two
CO_HOT_MIN = 4
CO_KM_N = 5_000_000                    # (d): config 3's table cut to a quarter (the group's time), over the budget
CO_KM_ITERS = 3
CO_PCA_N = 262_144                     # (d): config 5's width, rows cut as group (f)'s
CO_BUDGET = 256 << 20


def _rearm():
    """Re-read the ledger's and the tuner's knobs (the block's)."""
    port_costs.reset_for_tests()
    port_autotune.reset_for_tests()
    return port_costs.active(), port_autotune.active()


def _compile_counts() -> dict:
    return {k: v for k, v in counters("compile.").items() if v}


def _graph_pool_reserved(prog) -> int:
    """Bytes the caching allocator has reserved in one graph's private pool."""
    pool = tuple(prog.graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id") or ()) == pool)


def phase_cost_pca(gen: torch.Generator) -> dict:
    """(p-a) Config 5's ``pallas`` PCA fit (K1's float32 route) and three
    transforms through the program cache, with the ledger off and on:
    bitwise, as many K1 launches; the fit's ``RunReport.costs`` holds the
    Gram's program, every entry's flops is its count, every roofline row's
    utilization is at most 1; device time per program beside its host
    enqueue time. Then the same rows from the host (float64 placement,
    K1's float64 route) under the HBM sampler: ``.hbm`` names the span
    where the 4 GiB input grew the peak, and ``mean center`` grows it by
    at most the placed float64 block (the fold holds no (n, d) temporary)."""
    from spark_rapids_ml_tpu_torch.core.serving import bucket_rows

    x = planted(MS_N, D, gen)
    est = PCA().setK(K).setCovarianceBackend("pallas")
    est.fit(x)
    sync()
    k1.reset_launches()
    off = est.fit(x)
    off_launches = k1.launches
    off_outs = [off.transform(x[:n]) for n in CO_TRANSFORM_SIZES]
    with knob(TPUML_COST_LEDGER="1"):
        _rearm()
        k1.reset_launches()
        on = est.fit(x)
        sync()
        on_launches = k1.launches
        on_outs = [on.transform(x[:n]) for n in CO_TRANSFORM_SIZES]
        host_ms = {}
        for n in CO_TRANSFORM_SIZES:
            xb = x[:n]
            sync()
            times = []
            for _ in range(CO_HOST_CALLS):
                t0 = time.perf_counter()
                on.transform(xb)
                times.append(time.perf_counter() - t0)
            sync()
            host_ms[n] = statistics.median(times) * 1e3
        rep = on.fit_report()
        doc = port_costs.ledger_snapshot()
    sig = on.serving_signature()
    gram_count = k1.cost(MS_N, D, torch.float32)
    programs, bad_counts, over_one = [], [], []
    for e in doc["entries"]:
        if e["family"] == "covariance.gram":
            want = gram_count
            host = rep.stage_totals().get("compute cov", {}).get("seconds", 0.0) * 1e3
        elif e["family"] == "pca.transform":
            want = sig.cost(e["rows"], dtype=torch.float32)
            n = next(m for m in CO_TRANSFORM_SIZES if bucket_rows(m) == e["rows"])
            host = host_ms[n]
        else:
            want, host = None, None
        if want is not None and (e["flops"] != want["flops"] or e["bytes_accessed"] != want["bytes_accessed"]):
            bad_counts.append(e["key"])
        row = port_costs.roofline_row(e)
        if row["utilization"] is not None and row["utilization"] > 1.0:
            over_one.append(e["key"])
        programs.append({
            "family": e["family"], "spec": e["spec"], "kind": e["kind"], "invocations": e["invocations"],
            "device_ms_per_call": e["wall_seconds"] / max(e["invocations"], 1) * 1e3,
            "host_enqueue_ms": host, "flops": e["flops"], "bytes_accessed": e["bytes_accessed"],
            "temp_bytes": e["temp_bytes"], "utilization": row["utilization"],
            "achieved_tflop_s": (row["achieved_flops_per_sec"] or 0.0) / 1e12,
            "achieved_tb_s": (row["achieved_bytes_per_sec"] or 0.0) / 1e12,
        })
    report_rows = [r["family"] for r in rep.costs]
    bitwise = (bool(np.array_equal(on.pc, off.pc)) and bool(np.array_equal(on.explainedVariance, off.explainedVariance))
               and all(torch.equal(a, b) for a, b in zip(on_outs, off_outs)))
    host = x.cpu().numpy()
    del x, off_outs, on_outs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()  # the earlier phases' peak would hide the placement's growth
    with knob(TPUML_COST_LEDGER="1", TPUML_HBM_SAMPLE_EVERY_MS="2"):
        _rearm()
        hbm = est.fit(host).fit_report().hbm
    _rearm()
    grew = max(hbm.get("by_span", {}).items(), key=lambda kv: kv[1], default=(None, 0))
    placed = host.size * 8  # the rows placed as float64
    centred = hbm.get("by_span", {}).get("mean center", 0)
    # What the fold's own reduction takes: torch.mean over a block of the
    # placed shape (its values do not matter), alone.
    blk = torch.zeros(host.shape, dtype=torch.float64, device="cuda")
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.mean(blk, dim=0)
    sync()
    reduction = torch.cuda.max_memory_allocated() - base
    del blk
    out = {
        "phase": "cost_pca", "what": "PCA().setK(16).setCovarianceBackend('pallas'), 1,048,576 x 1,024 f32",
        "k1_launches": {"off": off_launches, "on": on_launches}, "bitwise": bitwise,
        "report_cost_rows": report_rows, "programs": programs, "counts_differ": bad_counts,
        "utilization_over_one": over_one,
        "hbm": {"delta": hbm.get("delta"), "by_span": hbm.get("by_span"), "largest": grew[0],
                "largest_bytes": grew[1], "input_bytes": host.nbytes, "placed_bytes": placed,
                "mean_center_bytes": centred, "mean_reduction_bytes": reduction},
        "timing": "device ms from CUDA events on the program's stream; host ms: the fit report's span, or the "
                  "median host wall of a transform call without a synchronize",
    }
    emit(out)
    require(off_launches == on_launches == 1, f"(p-a) K1 launches {out['k1_launches']}")
    require(bitwise, "(p-a) the ledgered fit or transforms differ from the unledgered ones")
    require("covariance.gram" in report_rows, f"(p-a) the fit report's costs: {report_rows}")
    require(not bad_counts, f"(p-a) entries whose flops or bytes are not their counts: {bad_counts}")
    require(not over_one, f"(p-a) roofline utilization above 1: {over_one}")
    require(grew[1] >= host.nbytes, f"(p-a) no span grew the peak by the input's bytes: {out['hbm']}")
    require(centred <= placed, f"(p-a) mean center grew the peak by more than the placed block: {out['hbm']}")
    return out


def phase_cost_serving(gen: torch.Generator) -> dict:
    """(p-b) Serving under the ledger at configs 15 and 3 (PCA 1,024 -> 16,
    KMeans k = 100 over 16): the bucket ladder's captures are classified
    ``new_program`` / ``new_bucket``, none ``retrace``, each output bitwise
    the eager kernel at its bucket; a wandering batch size on a cache of
    two gives ``eviction_refill``; rows forced inside a bucket give one
    ``RetraceStormWarning`` at ``TPUML_RETRACE_STORM``;
    ``measured_request_bytes`` lies between the output bytes and the graph
    pool's reserved bytes, and the runtime's admission prices measured;
    the merged document validates; a replay's host wall with the ledger
    off and on (median of 200)."""
    from spark_rapids_ml_tpu_torch.core import serving as core_serving
    from spark_rapids_ml_tpu_torch.core.serving import bucket_rows
    from spark_rapids_ml_tpu_torch.models import kmeans as km_mod
    from spark_rapids_ml_tpu_torch.models import pca as pca_mod
    from spark_rapids_ml_tpu_torch.serving import ServingRuntime

    dev = gen.device
    q, _ = torch.linalg.qr(torch.randn((SV_D, SV_K), generator=gen, device=dev, dtype=torch.float64))
    pca = PCAModel("co-pca", q.float().cpu().numpy(), np.full(SV_K, 1.0 / SV_K))
    c64 = torch.randn((KM_K, KM_D), generator=gen, device=dev, dtype=torch.float64) * KM_SCALE
    km = KMeansModel("co-km", c64.cpu().numpy())
    n_max = max(SV_SIZES)
    families = {
        "pca.transform": (pca.transform, pca_mod._project_kernel, (pca._pc_device(torch.float32, dev),),
                          {"precision": pca._serving_precision()},
                          torch.randn((n_max, SV_D), generator=gen, device=dev)),
        "kmeans.predict": (km.predict, km_mod._assign_kernel, (km._centers_on(dev, torch.float32),),
                           {"cosine": False, "precision": km._serving_precision()},
                           torch.randn((n_max, KM_D), generator=gen, device=dev) * KM_SCALE),
    }
    buckets = sorted({bucket_rows(n) for n in SV_SIZES})
    out = {"phase": "cost_serving", "sizes": list(SV_SIZES), "buckets": buckets}
    core_serving.clear_program_cache()
    with knob(TPUML_COST_LEDGER="1", TPUML_RETRACE_STORM="3"):
        _rearm()
        clear_counters("compile.")
        bitwise = True
        for name, (call, kernel, weights, static, x) in families.items():
            for n in SV_SIZES:
                got = call(x[:n])
                b = bucket_rows(n)
                xp = torch.zeros((b, x.shape[1]), dtype=x.dtype, device=dev)
                xp[:n] = x[:n]
                bitwise &= bool(torch.equal(got, kernel(xp, *weights, **static)[:n]))
        out["ladder_classes"] = _compile_counts()
        out["ladder_bitwise_eager_at_bucket"] = bitwise
        # Measured bytes against each graph's pool.
        measured = []
        with core_serving._LOCK:
            progs = [p for p in core_serving._PROGRAMS.values() if p.name == "pca.transform"]
        pca_w = families["pca.transform"][2]
        for prog in progs:
            mrb = port_costs.measured_request_bytes(prog.fn, prog.static, prog.bucket, prog.d, prog.dtype, pca_w)
            out_bytes = prog.bucket * SV_K * 4
            measured.append({"bucket": prog.bucket, "measured_request_bytes": mrb, "output_bytes": out_bytes,
                             "pool_reserved_bytes": _graph_pool_reserved(prog)})
        out["measured"] = sorted(measured, key=lambda m: m["bucket"])
        # Admission: the first request of a bucket is declared, the next measured.
        m0, d0 = counter_value("serving.admission.measured"), counter_value("serving.admission.declared")
        rows3 = torch.randn((3, SV_D), generator=gen, device=dev, dtype=torch.float64).cpu().numpy()
        with ServingRuntime(max_batch=8, max_delay_ms=1.0) as rt:
            rt.register("pca", pca)
            first = rt.submit("pca", rows3).result(timeout=60)
            second = rt.submit("pca", rows3).result(timeout=60)
        out["admission"] = {"measured": counter_value("serving.admission.measured") - m0,
                            "declared": counter_value("serving.admission.declared") - d0,
                            "answers_equal": bool(np.array_equal(first, second))}
        # A wandering batch size on a cache of two.
        with knob(TPUML_SERVING_CACHE_SIZE="2"):
            c0 = _compile_counts()
            call, _, _, _, x = families["kmeans.predict"]
            for n in CO_WANDER:
                call(x[:n])
            c1 = _compile_counts()
        out["wander_classes"] = {k: c1.get(k, 0) - c0.get(k, 0) for k in c1 if c1.get(k, 0) != c0.get(k, 0)}
        # Rows forced inside the 16-row bucket: the storm.
        _, kernel, weights, static, _ = families["kmeans.predict"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for rows in CO_BYPASS_ROWS:
                core_serving._get_program(kernel, rows, KM_D, torch.float32, dev, weights, static, "co.bypass")
        storms = [str(w.message) for w in caught if issubclass(w.category, port_costs.RetraceStormWarning)]
        snap = port_costs.ledger_snapshot()
        out["storm_warnings"] = storms
        out["retraces"] = snap["retraces"]
        merged = port_costs.merge_ledger_docs([snap])
        out["merged_problems"] = port_costs.validate_ledger(merged)
        out["merged_entries"] = len(merged["entries"])
        # The ledger's cost per request: one replay, off and on, twice.
        call, _, _, _, x = families["pca.transform"]
        xb = x[:CO_REPLAY_ROWS]
        replay = {}
        for state in ("on_1", "off_1", "on_2", "off_2"):
            if state.startswith("off"):
                port_costs.configure(enable=False)
            else:
                port_costs.configure(enable=True)
            replay[state] = _median_call_ms(lambda: call(xb))
        out["replay_call_ms_median_of_200"] = replay
    _rearm()
    core_serving.clear_program_cache()
    emit(out)
    classes = out["ladder_classes"]
    require(out["ladder_bitwise_eager_at_bucket"], "(p-b) a ledgered replay differs from the eager kernel at its bucket")
    require(classes.get("compile.new_program") == 2 and classes.get("compile.new_bucket") == 2 * (len(buckets) - 1)
            and "compile.retrace" not in classes, f"(p-b) the ladder's classes: {classes}")
    require(out["wander_classes"].get("compile.eviction_refill", 0) >= 3
            and "compile.retrace" not in out["wander_classes"], f"(p-b) the wandering size: {out['wander_classes']}")
    require(len(storms) == 1 and out["retraces"]["families"].get("co.bypass") == len(CO_BYPASS_ROWS) - 1,
            f"(p-b) the storm: {storms}, {out['retraces']}")
    for m in out["measured"]:
        require(m["measured_request_bytes"] is not None
                and m["output_bytes"] <= m["measured_request_bytes"] <= m["pool_reserved_bytes"],
                f"(p-b) measured bytes out of [output, pool]: {m}")
    require(out["admission"]["measured"] >= 1 and out["admission"]["answers_equal"], f"(p-b) admission: {out['admission']}")
    require(not out["merged_problems"], f"(p-b) the merged document: {out['merged_problems'][:3]}")
    return out


def phase_cost_tuner_runtime(gen: torch.Generator, tmp: str) -> dict:
    """(p-c) Config 16's runtime (KMeans k = 100, d = 16) with
    ``TPUML_AUTOTUNE=on`` and a fresh store: a 12-row batch seen
    ``TPUML_AUTOTUNE_HOT_MIN`` times earns an exact rung, bitwise the eager
    kernel at that rung; the batcher's window is the tuner's p95 of the
    measured walls; 16 closed-loop threads x 150 single rows, rows/s with
    the tuner off and on (recorded, no gain claimed), every answer equal to
    a float64 assignment off the margin band."""
    from spark_rapids_ml_tpu_torch.models import kmeans as km_mod
    from spark_rapids_ml_tpu_torch.serving import ServingRuntime

    dev = gen.device
    c64 = torch.randn((KM_K, KM_D), generator=gen, device=dev, dtype=torch.float64) * KM_SCALE
    model = KMeansModel("co16", c64.cpu().numpy())
    total = SV_THREADS * SV_REQUESTS
    idx = torch.randint(0, KM_K, (total,), generator=gen, device=dev)
    rows = c64[idx] + 4.0 * torch.randn((total, KM_D), generator=gen, device=dev, dtype=torch.float64)
    labels64, band = _assign_f64(rows, c64)
    probes = rows.cpu().numpy().reshape(SV_THREADS, SV_REQUESTS, KM_D)
    x_hot = rows[:CO_HOT_N].float()

    def closed_loop() -> dict:
        rt = ServingRuntime(max_batch=SV_THREADS, max_delay_ms=5.0, queue_limit=4 * total)
        rt.register("km", model)
        rt.warm("km", buckets=[1 << p for p in range(5)])
        wall, answers, _ = _closed_loop(rt, probes)
        first = types.SimpleNamespace(version=types.SimpleNamespace(signature=model.serving_signature()))
        window = rt._batcher._delay_s_for(first)
        rt.close()
        got = torch.from_numpy(answers.reshape(-1)).to(dev)
        off = got != labels64
        return {"rows_per_s": total / wall, "window_s": window, "differ_off_band": int((off & ~band).sum())}

    out = {"phase": "cost_tuner_runtime", "model": [KM_K, KM_D], "hot_rows": CO_HOT_N, "hot_min": CO_HOT_MIN}
    # The serving precision is pinned: (e) is the gate's own phase.
    with knob(TPUML_PRECISION_SERVING="f32"):
        out["tuner_off"] = closed_loop()
        with knob(TPUML_AUTOTUNE="on", TPUML_TUNE_STORE=os.path.join(tmp, "runtime.json"),
                  TPUML_AUTOTUNE_HOT_MIN=str(CO_HOT_MIN)):
            _, tuner = _rearm()
            outs = [model.predict(x_hot) for _ in range(CO_HOT_MIN + 2)]
            weights = (model._centers_on(dev, torch.float32),)
            eager = km_mod._assign_kernel(x_hot, *weights, cosine=False, precision=model._serving_precision())
            out["rung"] = tuner.peek_serving_bucket("kmeans.predict", KM_D, CO_HOT_N, 16)
            out["rung_outputs_bitwise_eager"] = all(bool(torch.equal(o, eager)) for o in outs[CO_HOT_MIN - 1:])
            out["tuner_on"] = closed_loop()
            out["tuner_on"]["tuner_window_s"] = tuner.recommend_delay_s("kmeans.predict", 0.005)
            out["tuner_on"]["wall_samples"] = tuner.snapshot()["wall_samples"]
            out["ladders"] = tuner.snapshot()["ladders"]
            out["store_decisions"] = sorted(d["knob"] for d in tuner.store.snapshot())
    _rearm()
    out["on_over_off_rows_s"] = out["tuner_on"]["rows_per_s"] / out["tuner_off"]["rows_per_s"]
    emit(out)
    require(out["rung"] == CO_HOT_N and out["rung_outputs_bitwise_eager"], f"(p-c) the rung: {out['rung']}")
    require(out["tuner_on"]["window_s"] == out["tuner_on"]["tuner_window_s"] != 0.005,
            f"(p-c) the batcher's window: {out['tuner_on']}")
    for run in ("tuner_off", "tuner_on"):
        require(out[run]["differ_off_band"] == 0, f"(p-c) {run}: an answer differs from float64")
    return out


def phase_cost_streaming(gen: torch.Generator, tmp: str) -> dict:
    """(p-d) Streaming under the tuner: config 3's KMeans (rows cut to 5M)
    and config 5's PCA (262,144 x 1,024) from the host, degraded under a
    256 MiB fit budget, take the tuner's block rows; ``solver.segment=1:oom``
    halves the KMeans block once through ``note_oom``, and both decisions
    land in the store; each result equals the explicit block-reader fit at
    the block that was used."""
    x_km = planted_blobs(CO_KM_N, KM_D, KM_K, gen)[0].cpu().numpy()
    x_pca = planted(CO_PCA_N, D, gen).cpu().numpy()
    km = KMeans().setK(KM_K).setSeed(SEED).setMaxIter(CO_KM_ITERS).setBackend("xla")
    est = PCA().setK(K)
    out = {"phase": "cost_streaming", "budget_bytes": CO_BUDGET}
    with knob(TPUML_AUTOTUNE="on", TPUML_TUNE_STORE=os.path.join(tmp, "stream.json"), TPUML_FIT_MEM_BUDGET=CO_BUDGET,
              TPUML_PRECISION_KMEANS="f32", TPUML_PRECISION_PCA="f32"), warnings.catch_warnings():
        warnings.simplefilter("ignore", DegradationWarning)
        _, tuner = _rearm()
        first = {"kmeans": fit_block_rows("kmeans", width=KM_D, itemsize=4),
                 "pca": fit_block_rows("pca", width=D, itemsize=4)}
        h0 = counter_value("fit.oom.block_halved")
        with inject("solver.segment=1:oom") as plan:
            recovered = km.fit(x_km)
        halvings = counter_value("fit.oom.block_halved") - h0
        streamed = est.fit(x_pca)
        used = {fam: tuner.store.get("fit_block_rows", fam)["value"] for fam in ("kmeans", "pca")}
        ceiling = tuner.store.get("fit_oom_ceiling", "kmeans")
    with knob(TPUML_PRECISION_KMEANS="f32", TPUML_PRECISION_PCA="f32"):
        _rearm()
        explicit_km = km.fit(HostArrayBlockReader(x_km, block_rows=used["kmeans"]))
        explicit_pca = est.fit(HostArrayBlockReader(x_pca, block_rows=used["pca"]))
    out.update({
        "tuner_first_block_rows": first, "used_block_rows": used, "fired": plan.fired, "block_halved": halvings,
        "oom_ceiling": ceiling["value"] if ceiling else None,
        "kmeans_bitwise": bool(np.array_equal(recovered.clusterCenters(), explicit_km.clusterCenters())
                               and recovered.trainingCost == explicit_km.trainingCost
                               and recovered.numIter == explicit_km.numIter),
        "pca_bitwise": bool(np.array_equal(streamed.pc, explicit_pca.pc)
                            and np.array_equal(streamed.explainedVariance, explicit_pca.explainedVariance)),
    })
    emit(out)
    require(halvings == 1 and plan.fired == [("solver.segment", 0)]
            and used["kmeans"] == max(membudget.MIN_BLOCK_ROWS, first["kmeans"] // 2), f"(p-d) the KMeans block: {out}")
    require(out["oom_ceiling"] is not None and used["pca"] == first["pca"], f"(p-d) the store: {out}")
    require(out["kmeans_bitwise"] and out["pca_bitwise"], f"(p-d) a streamed fit differs from its reader fit: {out}")
    return out


def tune_child_main(argv) -> int:
    """``chip_smoke.py --tune-child STORE``: a fresh process reads the
    committed serving precision from the store; a probe would fail it."""
    from spark_rapids_ml_tpu_torch.ops import precision

    port_device.set_platform("cuda")
    port_device.use_ieee_fp32_matmul()
    store = argv[argv.index("--tune-child") + 1]
    probed = []

    def refuse(a, b, mode, repeats=3):
        probed.append(mode)
        raise RuntimeError("the committed mode was probed again")

    precision._time_probe = refuse
    with knob(TPUML_AUTOTUNE="on", TPUML_TUNE_STORE=store):
        _rearm()
        mode = precision.resolve_policy("serving")
    print(json.dumps({"mode": mode, "probed": probed}), flush=True)
    return 0


def phase_cost_precision(tmp: str) -> dict:
    """(p-e) The precision gate on the card: with a fresh store the probe
    GEMM (512 x 256 x 256) is timed in f32, bf16x3 and bf16 (CUDA events,
    after a warm-up) and one mode commits for ``serving`` (and f32 or
    bf16x3 for ``pca``); a committed bf16x3 or bf16 passed its parity
    bound; a second process reads the committed mode without probing."""
    from spark_rapids_ml_tpu_torch.ops import precision

    store = os.path.join(tmp, "precision.json")
    walls = {}
    real = precision._time_probe

    def spy(a, b, mode, repeats=3):
        res, wall = real(a, b, mode, repeats)
        walls.setdefault(mode, []).append(wall)
        return res, wall

    with knob(TPUML_AUTOTUNE="on", TPUML_TUNE_STORE=store):
        _, tuner = _rearm()
        precision._time_probe = spy
        try:
            modes = {fam: precision.resolve_policy(fam) for fam in ("serving", "pca")}
        finally:
            precision._time_probe = real
        decisions = {d["key"]: d for d in tuner.store.snapshot() if d["knob"] == precision.PRECISION_KNOB}
    _rearm()
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUML_")}
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--tune-child", store],
                           capture_output=True, text=True, timeout=OB_CHILD_TIMEOUT_S, env=env)
    got = json.loads(child.stdout.strip().splitlines()[-1]) if child.returncode == 0 else {"error": child.stderr[-2000:]}
    out = {"phase": "cost_precision", "probe": "512 x 256 x 256 f32 operands", "modes": modes,
           "probe_walls_ms": {m: [w * 1e3 for w in ws] for m, ws in walls.items()},
           "decisions": {k: {"value": d["value"], "metric": d["metric"], "evidence": d["evidence"],
                             "rejected": d["rejected"]} for k, d in decisions.items()},
           "second_process": got}
    emit(out)
    for fam, mode in modes.items():
        dec = decisions[fam]
        require(dec["value"] == mode, f"(p-e) {fam}: resolved {mode}, store {dec['value']}")
        if mode in precision.REL_TOL:
            err = float(next(e for e in dec["evidence"] if e.startswith("max_rel_err=")).split("=")[1])
            require(err <= precision.REL_TOL[mode], f"(p-e) {fam}: {mode} committed at error {err}")
    require(got.get("mode") == modes["serving"] and got.get("probed") == [], f"(p-e) the second process: {got}")
    return out


def costs_phases(card: str) -> dict:
    """Group (p), the cost ledger and the autotuner: (a) config 5's PCA fit
    and transforms under the ledger, (b) serving at configs 15 and 3 under
    it, (c) config 16's runtime under the tuner, (d) streaming and recovery
    under the tuner, (e) the precision gate; with ``TPUML_PEAK_FLOPS`` and
    ``TPUML_PEAK_BYTES_PER_SEC`` at the card's fp32 and HBM peaks, its own
    seed, within ``CO_WALL_LIMIT_S``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(CO_SEED)
    print(f"{card}; TPUML_PEAK_FLOPS={CO_PEAK_FLOPS:.4g} TPUML_PEAK_BYTES_PER_SEC={CO_PEAK_BYTES:.4g}", flush=True)
    t0 = time.perf_counter()
    walls = {}
    with knob(TPUML_PEAK_FLOPS=CO_PEAK_FLOPS, TPUML_PEAK_BYTES_PER_SEC=CO_PEAK_BYTES), \
            tempfile.TemporaryDirectory(prefix="costs-") as tmp:
        try:
            for name, run in (("a_pca", lambda: phase_cost_pca(gen)),
                              ("b_serving", lambda: phase_cost_serving(gen)),
                              ("c_tuner_runtime", lambda: phase_cost_tuner_runtime(gen, tmp)),
                              ("d_streaming", lambda: phase_cost_streaming(gen, tmp)),
                              ("e_precision", lambda: phase_cost_precision(tmp))):
                t = time.perf_counter()
                run()
                walls[name] = time.perf_counter() - t
                torch.cuda.empty_cache()
        finally:
            _rearm()
    wall = time.perf_counter() - t0
    emit({"phases": "costs", "card": card, "wall_s": wall, "phase_wall_s": walls,
          "peaks": {"flops_per_sec": CO_PEAK_FLOPS, "bytes_per_sec": CO_PEAK_BYTES}})
    require(wall <= CO_WALL_LIMIT_S, f"the cost phases took {wall:.1f} s, over their {CO_WALL_LIMIT_S:.0f} s")
    return walls


# --- group (q): the lock sanitizer and the ops plane -----------------------

OP_SEED = SEED + 800        # the group's data: drawn anew from its own seeds, alike in both processes
OP_WALL_LIMIT_S = 60.0
OP_STALL_MS = 100           # the child's TPUML_LOCKCHECK_STALL_MS
OP_HOLD_S = 1.0             # (d): a wedged registry held ten times the watchdog's threshold
OP_OPS_STALL_S = 1.0        # (d): the child's TPUML_OPS_STALL_S
OP_SCRAPE_EVERY_S = 0.05    # (c): one round of the four endpoints, then this pause
OP_MEM_BUDGET = 1 << 30     # (b): config 16's runtime's admission budget (on /varz)
OP_CHILD_TIMEOUT_S = 150
OP_SERVING_LOCKS = ("serving.batcher", "serving.admission", "serving.registry", "core_serving.programs")


def op_generator(offset: int) -> torch.Generator:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(OP_SEED + offset)
    return gen


def op_fits() -> dict:
    """(q-a) Config 5's ``pallas`` PCA fit on a 1,048,576 x 1,024 float32
    device tensor (K1, one launch, after a 4,096-row fit that warms a
    fresh process) and config 3's KMeans, k = 100 on ``auto`` over 20M x
    16 (K2, 3 launches): the fitted arrays, the launches and the walls."""
    x = planted(MS_N, D, op_generator(0))
    PCA().setK(K).setCovarianceBackend("pallas").fit(x[:4096])  # a fresh process's first fit warms its handles
    k1.reset_launches()
    sync()
    t0 = time.perf_counter()
    pca = PCA().setK(K).setCovarianceBackend("pallas").fit(x)
    sync()
    pca_wall = time.perf_counter() - t0
    k1_launches = k1.launches
    del x
    torch.cuda.empty_cache()
    gen = op_generator(1)
    truth = KM_SCALE * torch.randn((KM_K, KM_D), generator=gen, device=gen.device)
    x = blob_rows(KM_N, truth, op_generator(2))
    kk.reset_launches()
    sync()
    t0 = time.perf_counter()
    km = KMeans().setK(KM_K).setSeed(SEED).fit(x)
    sync()
    km_wall = time.perf_counter() - t0
    k2_launches = kk.launches["assign_stats_fused"]
    del x
    torch.cuda.empty_cache()
    arrays = {"pca_pc": np.asarray(pca.pc), "pca_ev": np.asarray(pca.explainedVariance),
              "km_centers": np.asarray(km.clusterCenters()), "km_cost": np.asarray(km.trainingCost),
              "km_iters": np.asarray(km.numIter)}
    return {"arrays": arrays, "k1_launches": k1_launches, "k2_launches": k2_launches,
            "pca_fit_wall_s": pca_wall, "kmeans_fit_wall_s": km_wall}


def op_ladder() -> dict:
    """(q-b) Config 15's bucket ladder: a ``PCAModel`` (1,024 -> 16) over
    float32 device batches of 1 to 65,536 rows, each a captured program."""
    gen = op_generator(3)
    q, _ = torch.linalg.qr(torch.randn((SV_D, SV_K), generator=gen, device=gen.device, dtype=torch.float64))
    pca = PCAModel("op-pca", q.float().cpu().numpy(), np.full(SV_K, 1.0 / SV_K))
    x = torch.randn((max(SV_SIZES), SV_D), generator=gen, device=gen.device)
    s0 = _serving_stats()
    arrays = {f"ladder_{n}": pca.transform(x[:n]).cpu().numpy() for n in SV_SIZES}
    return {"arrays": arrays, "captures": _serving_stats()["compiles"] - s0["compiles"]}


def op_runtime(max_batch: int, delay_ms: float, model, total: int):
    """Config 16's runtime: config 3's KMeans as ``km`` version 1 with a
    ``prod`` alias, an admission budget, the buckets up to ``max_batch``
    warmed."""
    from spark_rapids_ml_tpu_torch.serving import ServingRuntime

    rt = ServingRuntime(max_batch=max_batch, max_delay_ms=delay_ms, queue_limit=4 * total, mem_budget=OP_MEM_BUDGET)
    rt.register("km", model)
    rt.set_alias("km", "prod", 1)
    rt.warm("km", buckets=[1 << p for p in range(9) if (1 << p) <= max_batch])
    return rt


def op_config16(passes, scrape=None) -> dict:
    """(q-b) Config 16's closed loop, 16 threads x 150 single rows through a
    ``ServingRuntime``, for each (label, max_batch, delay ms) of
    ``passes``; ``scrape(rt)`` (a context manager) wraps the passes whose
    label ends in ``_scraped``. Each pass runs inside an open span, which
    encloses the scraper's whole life."""
    from spark_rapids_ml_tpu_torch.utils.tracing import TraceRange

    gen = op_generator(4)
    c64 = torch.randn((KM_K, KM_D), generator=gen, device=gen.device, dtype=torch.float64) * KM_SCALE
    model = KMeansModel("op16", c64.cpu().numpy())
    total = SV_THREADS * SV_REQUESTS
    idx = torch.randint(0, KM_K, (total,), generator=gen, device=gen.device)
    rows = c64[idx] + 4.0 * torch.randn((total, KM_D), generator=gen, device=gen.device, dtype=torch.float64)
    probes = rows.cpu().numpy().reshape(SV_THREADS, SV_REQUESTS, KM_D)
    arrays, runs = {}, {}
    for label, max_batch, delay_ms in passes:
        rt = op_runtime(max_batch, delay_ms, model, total)
        try:
            # The span opens before the scraper starts and closes after it
            # stops, so every /tracez answer sees it open.
            with TraceRange(f"opsplane config 16 {label}"), \
                    (scrape(rt) if label.endswith("_scraped") else contextlib.nullcontext()) as scraper:
                wall, answers, lat = _closed_loop(rt, probes)
        finally:
            rt.close()
        arrays[f"c16_{label}"] = answers
        runs[label] = {"max_batch": max_batch, "wall_s": wall, "rows_per_s": total / wall,
                       "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99))}
        if scraper is not None:
            runs[label]["scrape"] = scraper.summary()
    return {"arrays": arrays, "runs": runs}


def _http(url: str, timeout: float = 10.0) -> tuple:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode("utf-8")
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode("utf-8")


class Scraper:
    """(q-c) A thread that GETs ``/metrics``, ``/varz``, ``/healthz`` and
    ``/tracez`` in turn, then pauses ``OP_SCRAPE_EVERY_S``, until the block
    ends; it keeps every status, every latency and every body's check."""

    PATHS = ("/metrics", "/varz", "/healthz", "/tracez")

    def __init__(self, url: str, rt):
        self.url, self.rt = url, rt
        self.stop = threading.Event()
        self.statuses, self.problems = [], []
        self.lat_ms = {p: [] for p in self.PATHS}
        self.thread = threading.Thread(target=self._run, name="opsplane-scraper", daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        deadline = time.perf_counter() + 30
        while len(self.lat_ms["/tracez"]) < 1 and self.thread.is_alive() and time.perf_counter() < deadline:
            time.sleep(0.01)  # one whole round, however short the block
        self.stop.set()
        self.thread.join(timeout=30)
        require(not self.thread.is_alive(), "(q-c) the scraper did not stop")

    def _check(self, path: str, body: str) -> None:
        from spark_rapids_ml_tpu_torch.observability.metrics import parse_exposition

        if path == "/metrics":
            if "tpuml_serving_batch_dispatch" not in parse_exposition(body):
                self.problems.append("/metrics lacks the batcher's dispatch counter")
            return
        doc = json.loads(body)
        if path == "/varz":
            mine = [s for s in doc["serving"] if s["runtime"] == self.rt.runtime_id]
            km = mine[0]["models"].get("km", {}) if mine else {}
            if not mine or km.get("versions") != [1] or km.get("aliases") != {"prod": 1} \
                    or mine[0]["mem_budget"] != OP_MEM_BUDGET or mine[0]["queue_limit"] != self.rt.queue_limit:
                self.problems.append(f"/varz serving: {mine}")
            if "covariance.gram" not in ((doc.get("costs") or {}).get("families") or {}):
                self.problems.append(f"/varz costs: {doc.get('costs')}")
        elif path == "/healthz":
            if not doc["ok"]:
                self.problems.append(f"/healthz: {doc}")
        elif not any(s["name"].startswith("opsplane config 16") for t in doc["open"].values() for s in t["spans"]):
            self.problems.append("/tracez shows no open span of the loop")

    def _run(self) -> None:
        while not self.stop.is_set():
            for path in self.PATHS:
                t0 = time.perf_counter()
                status, body = _http(self.url + path)
                self.lat_ms[path].append((time.perf_counter() - t0) * 1e3)
                self.statuses.append(status)
                try:
                    self._check(path, body)
                except (ValueError, KeyError, TypeError) as exc:
                    self.problems.append(f"{path}: {type(exc).__name__}: {exc}")
            self.stop.wait(OP_SCRAPE_EVERY_S)

    def summary(self) -> dict:
        every = [v for lat in self.lat_ms.values() for v in lat]
        return {"rounds": len(self.lat_ms["/varz"]), "statuses": sorted(set(self.statuses)),
                "p50_ms": float(np.percentile(every, 50)) if every else None,
                "p99_ms": float(np.percentile(every, 99)) if every else None,
                "p50_ms_by_path": {p: float(np.percentile(v, 50)) for p, v in self.lat_ms.items() if v},
                "problems": self.problems[:5]}


def op_flips(tmp: str) -> dict:
    """(q-d) ``/healthz`` flips: a failing probe (503, then 200 once it is
    removed); a heartbeat whose manual beats stop for longer than
    ``TPUML_OPS_STALL_S`` (503 on ``heartbeat``, 200 after a beat); a
    thread holding the serving registry's lock ``OP_HOLD_S`` while another
    waits for it: one ``lockcheck`` stall event, one flight dump with
    reason ``stall`` whose ``locks`` shows the holder's held lock and the
    waiter's waited one, ``/healthz``'s ``lockcheck`` check false, and the
    waiter gets the lock; nothing raises."""
    from spark_rapids_ml_tpu_torch.observability import events, flightrec, opsplane
    from spark_rapids_ml_tpu_torch.observability.heartbeat import GangHeartbeat
    from spark_rapids_ml_tpu_torch.serving import ServingRuntime

    url = f"http://127.0.0.1:{opsplane.active_port()}/healthz"
    out = {"start": _http(url)[0]}
    opsplane.add_probe("opsplane_smoke.failing", lambda: False)
    out["probe_failing"] = _http(url)[0]
    opsplane.remove_probe("opsplane_smoke.failing")
    out["probe_removed"] = _http(url)[0]

    hb = GangHeartbeat(process_id=0, interval=0, manual=True).start()
    try:
        out["beating"] = _http(url)[0]
        t0 = time.perf_counter()
        status, body = _http(url)
        while status != 503 and time.perf_counter() - t0 < 10 * OP_OPS_STALL_S:
            time.sleep(0.05)
            status, body = _http(url)
        out["stale_heartbeat"] = {"status": status, "after_s": time.perf_counter() - t0,
                                  "check": json.loads(body)["checks"]["heartbeat"]}
        hb.beat()
        out["beat_again"] = _http(url)[0]
    finally:
        hb.stop()

    log = os.path.join(tmp, "q-events.jsonl")
    flight = os.path.join(tmp, "q-flight")
    events.configure(log)
    flightrec.reset()
    flightrec.arm()
    rt = ServingRuntime(start=False)
    lock = rt.registry._lock
    release = threading.Event()
    got = {}

    def holder():
        with lock:
            release.wait(OP_HOLD_S)

    def waiter():
        t = time.perf_counter()
        got["snapshot"] = rt.registry.snapshot()
        got["waited_s"] = time.perf_counter() - t

    h = threading.Thread(target=holder, name="wedged-registry")
    w = threading.Thread(target=waiter, name="registry-reader")
    with knob(TPUML_FLIGHT_DIR=flight):
        try:
            h.start()
            while not lock.locked():
                time.sleep(0.001)
            w.start()
            w.join(timeout=30)
            release.set()
            h.join(timeout=30)
        finally:
            flightrec.disarm()
            events.configure(None)
    rt.close()
    health = json.loads(_http(url)[1])
    recs = [json.loads(line) for line in open(log) if line.strip()]
    stalls = [r for r in recs if r.get("event") == "lockcheck"]
    dumps = sorted(glob.glob(os.path.join(flight, "flight-*.json")))
    doc = json.load(open(dumps[0])) if dumps else {}
    out["stall"] = {
        "waiter_got_the_lock": "snapshot" in got and not w.is_alive(), "waited_s": got.get("waited_s"),
        "lockcheck_events": [(r["action"], r["lock"]) for r in stalls], "flight_dumps": len(dumps),
        "flight_reason": doc.get("reason"), "flight_locks": doc.get("locks"),
        "healthz_lockcheck": health["checks"]["lockcheck"], "healthz_ok": health["ok"],
    }
    return out


def opsplane_child_main(argv) -> int:
    """(q)'s child, started with ``TPUML_LOCKCHECK=strict``: (a) and (b)
    as the parent runs them, (b)'s batched loop again under (c)'s
    scraper, then (d); it writes its arrays and readings beside each
    other and fails on any check of its own."""
    from spark_rapids_ml_tpu_torch.observability import costs as child_costs
    from spark_rapids_ml_tpu_torch.observability import opsplane
    from spark_rapids_ml_tpu_torch.observability.metrics import default_registry
    from spark_rapids_ml_tpu_torch.utils import lockcheck

    out_dir = argv[argv.index("--opsplane-child") + 1]
    port_device.set_platform("cuda")
    port_device.use_ieee_fp32_matmul()
    torch.backends.cudnn.allow_tf32 = False
    require(lockcheck.mode() == "strict" and child_costs.active() is not None, "(q) the child's knobs")
    require(opsplane.active_port() is not None, "(q) TPUML_OPS_PORT=0 started no ops server at import")
    url = f"http://127.0.0.1:{opsplane.active_port()}"
    fits = op_fits()
    ladder = op_ladder()
    c16 = op_config16((("unbatched", 1, 0.0), ("batched", SV_THREADS, 5.0), ("batched_scraped", SV_THREADS, 5.0)),
                      scrape=lambda rt: Scraper(url, rt))
    before_flips = lockcheck.violations()
    holds = default_registry.snapshot()["histograms"].get("lockcheck.hold_ms", {})
    held_by = sorted({k.split('lock="', 1)[1].split('"', 1)[0] for k in holds if 'lock="' in k})
    flips = op_flips(out_dir)
    readings = {
        "k1_launches": fits["k1_launches"], "k2_launches": fits["k2_launches"],
        "pca_fit_wall_s": fits["pca_fit_wall_s"], "kmeans_fit_wall_s": fits["kmeans_fit_wall_s"],
        "ladder_captures": ladder["captures"], "config16": c16["runs"], "violations_before_flips": before_flips,
        "hold_ms_locks": held_by, "flips": flips, "ops_port": opsplane.active_port(),
    }
    np.savez(os.path.join(out_dir, "q-child.npz"), **fits["arrays"], **ladder["arrays"], **c16["arrays"])
    with open(os.path.join(out_dir, "q-child.json"), "w") as fh:
        json.dump(readings, fh, default=str)
    opsplane.stop()
    return 0


def phase_opsplane(card: str, tmp: str) -> dict:
    """(q) The same work with the sanitizer off here and under ``strict`` in
    a child (with the ops server on an ephemeral port, the cost ledger on
    in both): bitwise alike; the child's readings checked; its order graph,
    read back from its exit dump, acyclic, with (d)'s stall its only
    violation."""
    with knob(TPUML_COST_LEDGER="1"):
        _rearm()
        fits = op_fits()
        ladder = op_ladder()
        c16 = op_config16((("unbatched", 1, 0.0), ("batched", SV_THREADS, 5.0)))
    _rearm()
    torch.cuda.empty_cache()
    ours = {**fits["arrays"], **ladder["arrays"], **c16["arrays"]}
    graph_path = os.path.join(tmp, "q-graph.json")
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUML_")}
    env.update(TPUML_LOCKCHECK="strict", TPUML_LOCKCHECK_STALL_MS=str(OP_STALL_MS),
               TPUML_LOCKCHECK_GRAPH=graph_path, TPUML_OPS_PORT="0", TPUML_OPS_STALL_S=str(OP_OPS_STALL_S),
               TPUML_COST_LEDGER="1")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--opsplane-child", tmp], env=env, cwd=tmp,
                          capture_output=True, text=True, timeout=OP_CHILD_TIMEOUT_S)
    child_wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"(q) the strict child failed ({proc.returncode}): {proc.stderr[-3000:]}")
    theirs = dict(np.load(os.path.join(tmp, "q-child.npz")))
    child = json.load(open(os.path.join(tmp, "q-child.json")))
    graph = json.load(open(graph_path))
    # Each array of the child against this process's; the scraped loop's
    # answers against the unscraped batched loop's here.
    pairs = {k: (v, ours.get(k.replace("_scraped", ""))) for k, v in theirs.items()}
    differ = sorted(set(ours) - set(theirs)) + sorted(
        k for k, (a, b) in pairs.items() if b is None or a.dtype != b.dtype or a.tobytes() != b.tobytes())
    names = sorted(set(graph["edges"]) | {d for dsts in graph["edges"].values() for d in dsts})
    flips = child["flips"]
    out = {
        "phase": "opsplane", "card": card, "child_wall_s": child_wall,
        "a": {"k1_launches": {"off": fits["k1_launches"], "strict": child["k1_launches"]},
              "k2_launches": {"off": fits["k2_launches"], "strict": child["k2_launches"]},
              "pca_fit_wall_s": {"off": fits["pca_fit_wall_s"], "strict": child["pca_fit_wall_s"]},
              "kmeans_fit_wall_s": {"off": fits["kmeans_fit_wall_s"], "strict": child["kmeans_fit_wall_s"]}},
        "b": {"ladder_captures": {"off": ladder["captures"], "strict": child["ladder_captures"]},
              "config16_rows_per_s": {
                  "off": {k: v["rows_per_s"] for k, v in c16["runs"].items()},
                  "strict": {k: v["rows_per_s"] for k, v in child["config16"].items()}},
              "config16_p99_ms": {"off": {k: v["p99_ms"] for k, v in c16["runs"].items()},
                                  "strict": {k: v["p99_ms"] for k, v in child["config16"].items()}},
              "hold_ms_locks": child["hold_ms_locks"],
              "violations_before_flips": child["violations_before_flips"],
              "graph_locks": names, "graph_edges": sum(len(v) for v in graph["edges"].values()),
              "graph_acyclic": _acyclic(graph["edges"]),
              "graph_violations": [(v["kind"], v["lock"]) for v in graph["violations"]]},
        "c": child["config16"]["batched_scraped"]["scrape"],
        "d": flips, "arrays_compared": len(pairs), "differ": differ,
        "timing": "walls and rows/s on the host clock; scrape latency per GET, host clock",
    }
    emit(out)
    require(not differ, f"(q) strict results differ from the sanitizer-off ones: {differ}")
    require(fits["k1_launches"] == child["k1_launches"] == 1, f"(q-a) K1 launches {out['a']['k1_launches']}")
    require(fits["k2_launches"] == child["k2_launches"] == 3, f"(q-a) K2 launches {out['a']['k2_launches']}")
    require(child["violations_before_flips"] == [], f"(q-b) violations: {child['violations_before_flips']}")
    require(out["b"]["graph_acyclic"], f"(q-b) the order graph has a cycle: {graph['edges']}")
    require(out["b"]["graph_violations"] == [("stall", "serving.registry")],
            f"(q-b) the dump's violations: {out['b']['graph_violations']}")
    require(set(OP_SERVING_LOCKS) <= set(child["hold_ms_locks"]),
            f"(q-b) lockcheck.hold_ms lacks a serving lock: {child['hold_ms_locks']}")
    require(out["c"]["statuses"] == [200] and out["c"]["rounds"] >= 1 and not out["c"]["problems"],
            f"(q-c) the scrapes: {out['c']}")
    require((flips["start"], flips["probe_failing"], flips["probe_removed"]) == (200, 503, 200),
            f"(q-d) the probe flip: {flips}")
    stale = flips["stale_heartbeat"]
    require(flips["beating"] == 200 and stale["status"] == 503 and stale["check"]["ok"] is False
            and flips["beat_again"] == 200, f"(q-d) the heartbeat flip: {flips}")
    st = flips["stall"]
    waited = {s["thread"] for s in st["flight_locks"] or [] if s["waiting"] == "serving.registry"}
    holding = {s["thread"] for s in st["flight_locks"] or [] if "serving.registry" in s["held"]}
    require(st["waiter_got_the_lock"] and st["lockcheck_events"] == [["stall", "serving.registry"]]
            and st["flight_dumps"] == 1 and st["flight_reason"] == "stall"
            and waited == {"registry-reader"} and holding == {"wedged-registry"}
            and st["healthz_lockcheck"] == {"ok": False, "stall_strikes": 1} and not st["healthz_ok"],
            f"(q-d) the stall strike: {st}")
    return out


def _acyclic(edges: dict) -> bool:
    state = {}

    def visit(node) -> bool:
        state[node] = 1
        for nxt in edges.get(node, ()):
            if state.get(nxt) == 1 or (nxt not in state and not visit(nxt)):
                return False
        state[node] = 2
        return True

    return all(state.get(n) == 2 or visit(n) for n in list(edges))


def opsplane_phases(card: str) -> dict:
    """Group (q), the lock sanitizer and the ops plane, within
    ``OP_WALL_LIMIT_S``: (a) configs 5 and 3's fits, (b) config 15's ladder
    and config 16's closed loop, off here and under ``strict`` in a child,
    bitwise alike; (c) the child's ops server scraped under config 16's
    traffic; (d) ``/healthz`` flips on a probe, a stale heartbeat and a
    stall strike."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="opsplane-") as tmp:
        out = phase_opsplane(card, tmp)
    wall = time.perf_counter() - t0
    emit({"phases": "opsplane", "card": card, "wall_s": wall})
    require(wall <= OP_WALL_LIMIT_S, f"the opsplane phases took {wall:.1f} s, over their {OP_WALL_LIMIT_S:.0f} s")
    return out


# --- group (r): the Spark layer on the card, through the pyspark stub ---------

SP_SEED = SEED + 900        # the group's data: drawn anew from its own seed
SP_WALL_LIMIT_S = 120.0
SP_PARTS = 4                # partitions of every stub DataFrame
SP_PCA_N = 65_536           # (b): config 5's 1,024 features; rows cut to what the stub holds as rows
SP_PCA_K = 16
SP_CHILD_PCA_N = 262_144    # (a): the child's config-5 rows, made on the card (no stub)
SP_CHILD_TIMEOUT_S = 90
SP_KM_N = 100_000           # (c): config 3's 16 features, k = 100; rows cut (stub)
SP_KM_ITERS = 20
SP_KM_CENTRE_TOL = 1e-9     # (c): relative to the largest centre coordinate; sums in another order
SP_GLM_N = 200_000          # (c), (d), (g): configs 4 and 10's 28 features; rows cut (stub)
SP_RF_N = 65_536            # (e): config 9's 16 features, 8 trees, depth 6, 16 bins; rows cut to the
                            # adapter's quantile-sample cap, so its edges are the core's
SP_NB_N = 100_000           # (e): configs 11 and 7's 96 features; items cut (stub)
SP_NB_Q = 1_000             # (e): queries
SP_DB_N = 100_000           # (e): config 12's 100,000 x 16, uncut
SP_CKPT_EVERY = 10          # (g): FISTA iterations a segment


def _sp_chunks(x: np.ndarray, parts: int = SP_PARTS) -> list:
    """The stub's partition layout of ``createDataFrame(..., numPartitions)``:
    contiguous chunks of ceil(n / parts) rows."""
    per = max(1, -(-x.shape[0] // parts))
    return [x[i:i + per] for i in range(0, x.shape[0], per)]


def _sp_df(spark, x: np.ndarray, y=None, parts: int = SP_PARTS):
    from pyspark.ml.linalg import Vectors

    if y is None:
        rows = [[Vectors.dense(v)] for v in x]
        return spark.createDataFrame(rows, ["features"], numPartitions=parts)
    rows = [[Vectors.dense(v), float(t)] for v, t in zip(x, y)]
    return spark.createDataFrame(rows, ["features", "label"], numPartitions=parts)


def _sp_column(model, df, col: str) -> np.ndarray:
    """A model's output column for every row, through the adapter's
    transform and the stub's ``pandas_udf``."""
    vals = [getattr(r, col) for r in model.transform(df).collect()]
    return np.stack([np.asarray(v.toArray() if hasattr(v, "toArray") else v) for v in vals])


def _sp_neighbours(model, qdf):
    rows = model.kneighbors(qdf).collect()
    return np.stack([r.distances for r in rows]), np.stack([r.indices for r in rows])


def sp_lloyd_reference(x: np.ndarray, k: int, seed: int, iters: int, tol: float) -> tuple:
    """``TpuKMeans``' semantics written plainly, for (r) (c) to hold the
    adapter's centres against: ``takeSample``'s uniform draw of 10 k rows
    (without replacement, numpy's generator from ``seed``, as the stub
    draws it), k-means++ on that sample with a second such generator, then
    float64 Lloyd over every row on the card until the largest centre
    shift is under ``tol``. Returns (centres, iterations)."""
    pick = np.random.default_rng(seed)
    sample = x[pick.choice(x.shape[0], size=min(max(10 * k, k), x.shape[0]), replace=False)]
    rng = np.random.default_rng(seed)
    centres = [sample[rng.integers(sample.shape[0])]]
    d2 = ((sample - centres[0]) ** 2).sum(axis=1)
    while len(centres) < k:
        c = sample[rng.choice(sample.shape[0], p=d2 / d2.sum() if d2.sum() > 0 else None)]
        centres.append(c)
        d2 = np.minimum(d2, ((sample - c) ** 2).sum(axis=1))
    xt = torch.from_numpy(x).cuda()
    c = torch.from_numpy(np.stack(centres)).cuda()
    done = 0
    for done in range(1, iters + 1):
        a = torch.cdist(xt, c, compute_mode="donot_use_mm_for_euclid_dist").argmin(dim=1)
        counts = torch.bincount(a, minlength=k).double()
        sums = torch.zeros_like(c).index_add_(0, a, xt)
        new = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None], c)
        shift = float((new - c).norm(dim=1).max())
        c = new
        if shift < tol:
            break
    return c.cpu().numpy(), done


def _sp_wall(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _sp_launches() -> dict:
    return {"centered_gram": k1.launches, **kk.launches, **k4.launches}


def _sp_fit(sp: dict, fn):
    """An adapter fit, timed, with every kernel's launch count set to 0
    just before and read just after, summed into the group's counts."""
    k1.reset_launches()
    kk.reset_launches()
    k4.reset_launches()
    out, wall = _sp_wall(fn)
    counts = _sp_launches()
    for name, n in counts.items():
        sp["launches"][name] += n
    return out, wall, counts


def _sp_same_splits(a, b) -> dict:
    """The forest parity rule of ``tests/test_torch_spark_adapter.py``."""
    from spark_rapids_ml_tpu_torch.core.lazy_state import to_host

    fa, fb = to_host(a.feature), to_host(b.feature)
    same = fa == fb
    return {"same_feature_share": float(same.mean()),
            "gain_max_abs": float(np.abs(to_host(a.node_gain) - to_host(b.node_gain)).max()),
            "threshold_max_abs_same_feature": float(
                np.abs(to_host(a.threshold)[same] - to_host(b.threshold)[same]).max())}


def spark_child_main(argv) -> int:
    """(a) in a process of its own: ``bringup_executor`` pins the card and
    joins an NCCL world of one, then config 5's PCA on ``global_mesh()``
    and on a (1, 1) mesh of the same rows."""
    port = argv[argv.index("--spark-port") + 1]
    out = argv[argv.index("--spark-out") + 1]
    import torch.distributed as dist

    port_device.set_platform("cuda")
    gang.bringup_executor(f"127.0.0.1:{port}", 1, 0)
    port_device.use_ieee_fp32_matmul()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SP_SEED + 1)
    x = planted(SP_CHILD_PCA_N, D, gen)
    mesh = gang.global_mesh()
    a = PCA(mesh=mesh).setK(K).fit(x)
    b = PCA(mesh=make_mesh((1, 1))).setK(K).fit(x)
    res = {"visible": visible, "backend": dist.get_backend(), "world": dist.get_world_size(),
           "mesh": list(mesh.grid.shape),
           "bitwise": bool(np.array_equal(a.pc, b.pc) and np.array_equal(a.explainedVariance, b.explainedVariance))}
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
    print("spark child ok", flush=True)
    return 0


def phase_spark_resources(sp: dict, tmp: str) -> dict:
    """(a) The discovery script's addresses are ``nvidia-smi``'s indices;
    ``bringup_executor`` in a child pins the card, joins NCCL and fits
    config 5's PCA on ``global_mesh()`` bitwise its (1, 1) mesh fit."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "spark_rapids_ml_tpu_torch", "spark",
                          "discovery", "get_gpus_resources.sh")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    found = json.loads(subprocess.run(["bash", script], capture_output=True, text=True, check=True, env=env,
                                      timeout=30).stdout)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.split()
    with contextlib.closing(__import__("socket").socket()) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_path = os.path.join(tmp, "spark_child.json")
    child_env = dict(env, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--spark-child", "--spark-port", str(port),
                             "--spark-out", out_path], env=child_env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        stdout, stderr = proc.communicate(timeout=SP_CHILD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    child_wall = time.perf_counter() - t0
    require(proc.returncode == 0 and "spark child ok" in stdout, f"(r-a) the bring-up child failed: {stderr[-2000:]}")
    with open(out_path) as f:
        child = json.load(f)
    out = {"phase": "spark_resources", "discovered": found, "nvidia_smi_indices": smi, "child": child,
           "child_wall_s": child_wall}
    emit(out)
    require(found == {"name": "gpu", "addresses": smi}, f"(r-a) discovery {found} against nvidia-smi {smi}")
    require(child["visible"] == "0" and child["backend"] == "nccl" and child["world"] == 1
            and child["mesh"] == [1, 1], f"(r-a) the child's bring-up: {child}")
    require(child["bitwise"], "(r-a) the global_mesh PCA differs from the (1, 1) mesh fit")
    return out


def phase_spark_pca(sp: dict, gen: torch.Generator) -> dict:
    """(b) ``TpuPCA`` at config 5's 1,024 features: the driver's ``eigh`` on
    ``cuda:0``, held to a float64 numpy oracle and to the host eigensolve
    at 1e-9 (sign-invariant); the transform through the stub."""
    A, spark = sp["adapter"], sp["spark"]
    x = planted_f64(SP_PCA_N, D, 32, gen).cpu().numpy()
    df = _sp_df(spark, x)
    calls = []
    real = A._driver_device

    def spy(gpu_id=-1):
        dev = real(gpu_id)
        calls.append(str(dev))
        return dev

    A._driver_device = spy
    try:
        model, wall, _ = _sp_fit(sp, lambda: A.TpuPCA(k=SP_PCA_K, inputCol="features", outputCol="pca").fit(df))
    finally:
        A._driver_device = real
    host, host_wall, _ = _sp_fit(sp, lambda: A.TpuPCA(k=SP_PCA_K, inputCol="features").setUseCuSolverSVD(False).fit(df))
    direct, direct_wall = _sp_wall(lambda: PCA().setK(SP_PCA_K).fit(torch.from_numpy(x).cuda()))
    w, v = np.linalg.eigh(np.cov(x, rowvar=False))
    oracle = v[:, ::-1][:, :SP_PCA_K]
    pc = np.asarray(model.pc.toArray())
    proj = _sp_column(model, df, "pca")
    out = {"phase": "spark_pca", "config": "BASELINE config 5", "x": [SP_PCA_N, D, "float64"],
           "partitions": SP_PARTS, "eigh_devices": calls,
           "adapter_fit_wall_s": wall, "host_eigh_fit_wall_s": host_wall, "direct_fit_wall_s": direct_wall,
           "pc_vs_f64_oracle": _pc_err_aligned(pc, oracle),
           "pc_vs_host_eigh": _pc_err_aligned(pc, np.asarray(host.pc.toArray())),
           "transform_max_abs": float(np.abs(proj - x @ pc).max()), "card": sp["card"]}
    emit(out)
    require(calls == ["cuda:0"], f"(r-b) the driver's eigh ran on {calls}")
    require(out["pc_vs_f64_oracle"] <= 1e-9, f"(r-b) components against the float64 oracle: {out['pc_vs_f64_oracle']}")
    require(out["pc_vs_host_eigh"] <= 1e-9, f"(r-b) components against the host eigh: {out['pc_vs_host_eigh']}")
    require(out["transform_max_abs"] <= 1e-9, f"(r-b) transform: {out['transform_max_abs']}")
    return out


def phase_spark_kmeans_linear(sp: dict, gen: torch.Generator) -> dict:
    """(c) ``TpuKMeans`` at config 3 (16 features, k = 100): centres
    within 1e-9 of :func:`sp_lloyd_reference` on the same rows and
    predictions that are the float64 nearest centre on the card;
    ``TpuLinearRegression`` at config 4 (28 features) against the
    port's float64 fit on the card, and its elastic net refused."""
    A, spark = sp["adapter"], sp["spark"]
    xk, _ = planted_blobs(SP_KM_N, KM_D, KM_K, gen)
    xk = xk.double().cpu().numpy()
    dfk = _sp_df(spark, xk)
    km_est = A.TpuKMeans(k=KM_K).setSeed(SEED).setMaxIter(SP_KM_ITERS)
    km, km_wall, _ = _sp_fit(sp, lambda: km_est.fit(dfk))
    direct_km, direct_km_wall = _sp_wall(
        lambda: KMeans().setK(KM_K).setSeed(SEED).setMaxIter(SP_KM_ITERS).fit(torch.from_numpy(xk).cuda()))
    centres = np.stack(km.clusterCenters())
    ref_centres, ref_iters = sp_lloyd_reference(xk, KM_K, SEED, SP_KM_ITERS, km_est.getOrDefault(km_est.tol))
    pred = _sp_column(km, dfk, "prediction")
    d64 = torch.cdist(torch.from_numpy(xk).cuda(), torch.from_numpy(centres).cuda(),
                      compute_mode="donot_use_mm_for_euclid_dist")
    nearest = torch.argmin(d64, dim=1).cpu().numpy()

    x4 = planted_f64(SP_GLM_N, GLM_D, 8, gen)
    w_true = torch.randn(GLM_D, generator=gen, device=x4.device, dtype=torch.float64)
    y4 = x4 @ w_true + 0.1 * torch.randn(SP_GLM_N, generator=gen, device=x4.device, dtype=torch.float64)
    x4n, y4n = x4.cpu().numpy(), y4.cpu().numpy()
    df4 = _sp_df(spark, x4n, y4n)
    lin, lin_wall, _ = _sp_fit(sp, lambda: A.TpuLinearRegression().setRegParam(0.1).fit(df4))
    direct, direct_wall = _sp_wall(lambda: LinearRegression().setRegParam(0.1).fit((x4, y4)))
    coef = np.asarray(lin.coefficients.toArray())
    pred4 = _sp_column(lin, df4, "prediction")
    try:
        A.TpuLinearRegression().setElasticNetParam(0.5).fit(df4)
        enet_refused = False
    except ValueError as exc:
        enet_refused = "elasticNetParam" in str(exc)
    out = {"phase": "spark_kmeans_linear",
           "kmeans": {"config": "BASELINE config 3", "x": [SP_KM_N, KM_D, "float64"], "k": KM_K,
                      "adapter_fit_wall_s": km_wall, "direct_fit_wall_s": direct_km_wall,
                      "finite": bool(np.isfinite(centres).all()), "centres": list(centres.shape),
                      "reference_lloyd_iterations": ref_iters,
                      "centres_max_abs_vs_reference": float(np.abs(centres - ref_centres).max()),
                      "predictions_not_f64_nearest": int(np.sum(pred != nearest))},
           "linear": {"config": "BASELINE config 4", "x": [SP_GLM_N, GLM_D, "float64"],
                      "adapter_fit_wall_s": lin_wall, "direct_fit_wall_s": direct_wall,
                      "coef_rel_vs_direct": float(np.abs(coef - direct.coefficients).max()
                                                  / np.abs(direct.coefficients).max()),
                      "intercept_abs_vs_direct": abs(lin.intercept - direct.intercept),
                      "predict_max_abs": float(np.abs(pred4 - direct.predict(x4).cpu().numpy()).max()),
                      "elastic_net_refused": enet_refused},
           "card": sp["card"]}
    emit(out)
    require(out["kmeans"]["finite"] and centres.shape == (KM_K, KM_D), "(r-c) KMeans centres")
    require(out["kmeans"]["centres_max_abs_vs_reference"] <= SP_KM_CENTRE_TOL * max(1.0, float(np.abs(ref_centres).max())),
            f"(r-c) KMeans centres against the plain Lloyd reference: {out['kmeans']}")
    require(out["kmeans"]["predictions_not_f64_nearest"] == 0, f"(r-c) KMeans predictions: {out['kmeans']}")
    require(out["linear"]["coef_rel_vs_direct"] <= 1e-9 and out["linear"]["intercept_abs_vs_direct"] <= 1e-9,
            f"(r-c) linear against the direct fit: {out['linear']}")
    require(out["linear"]["predict_max_abs"] <= 1e-8, f"(r-c) linear predictions: {out['linear']}")
    require(enet_refused, "(r-c) the adapter's linear regression took an elastic net")
    return out


def phase_spark_logistic(sp: dict, gen: torch.Generator) -> dict:
    """(d) ``TpuLogisticRegression`` at config 10 through ``gang_fit`` on
    the card: bitwise the port's own fit on a (1, 1) mesh of the rows."""
    A, spark = sp["adapter"], sp["spark"]
    x = planted_f64(SP_GLM_N, GLM_D, 8, gen)
    w_true = torch.randn(GLM_D, generator=gen, device=x.device, dtype=torch.float64)
    mu, sd = x.mean(dim=0), x.std(dim=0)
    y = ((((x - mu) / sd) @ w_true + 0.5 * torch.randn(SP_GLM_N, generator=gen, device=x.device,
                                                         dtype=torch.float64)) > 0).double()
    xn, yn = x.cpu().numpy(), y.cpu().numpy()
    df = _sp_df(spark, xn, yn)
    model, wall, _ = _sp_fit(sp, lambda: A.TpuLogisticRegression().setMaxIter(100).setRegParam(0.01).fit(df))
    mesh = gang.global_mesh()
    require(list(mesh.grid.shape) == [1, 1], f"(r-d) the member's mesh is {list(mesh.grid.shape)}, not (1, 1)")
    direct, direct_wall = _sp_wall(
        lambda: LogisticRegression(mesh=mesh).setMaxIter(100).setRegParam(0.01).fit((xn, yn)))
    core = model._core
    pred = _sp_column(model, df, "prediction")
    out = {"phase": "spark_logistic", "config": "BASELINE config 10", "x": [SP_GLM_N, GLM_D, "float64"],
           "adapter_fit_wall_s": wall, "direct_mesh_fit_wall_s": direct_wall, "num_iter": core.numIter,
           "bitwise_mesh_fit": (core.coefficients.tobytes() == direct.coefficients.tobytes()
                                and core.intercept == direct.intercept and core.numIter == direct.numIter),
           "predictions_vs_direct": int(np.sum(pred != np.asarray(direct.predict(xn)).astype(float))),
           "card": sp["card"]}
    emit(out)
    require(out["bitwise_mesh_fit"], f"(r-d) the gang fit differs from the (1, 1) mesh fit: {out}")
    require(out["predictions_vs_direct"] == 0, f"(r-d) predictions: {out}")
    return {"out": out, "df": df, "x": xn, "y": yn, "model": model}


def phase_spark_neighbours(sp: dict, gen: torch.Generator) -> dict:
    """(e) Config 9's forest, configs 11 and 7's kNN and ANN, config 12's
    DBSCAN: each equal to the port's direct fit of the same rows, as the
    parity tests define it."""
    A, spark = sp["adapter"], sp["spark"]
    out = {"phase": "spark_neighbours", "card": sp["card"]}
    # Config 9: nothing drawn on the executors (no bootstrap), so the
    # forest is the core's; the feature-subset draws are the core's.
    x9 = torch.randn((SP_RF_N, RF_D), generator=gen, device="cuda", dtype=torch.float64)
    margin = x9[:, 0] + 0.5 * x9[:, 1] * x9[:, 2] - 0.25 * x9[:, 3]
    y9 = (margin > 0).double()
    x9n, y9n = x9.cpu().numpy(), y9.cpu().numpy()
    df9 = _sp_df(spark, x9n, y9n)

    def rf(e):
        return e.setNumTrees(RF_TREES).setMaxDepth(RF_DEPTH).setMaxBins(RF_BINS).setSeed(SEED).setBootstrap(False)

    forest, rf_wall, _ = _sp_fit(sp, lambda: rf(A.TpuRandomForestClassifier()).fit(df9))
    direct_rf, direct_rf_wall = _sp_wall(lambda: rf(RandomForestClassifier()).fit((x9n, y9n)))
    f = forest._core._forest
    pred9 = _sp_column(forest, df9, "prediction")
    out["forest"] = dict(config="BASELINE config 9", x=[SP_RF_N, RF_D, "float64"], trees=RF_TREES,
                         depth=RF_DEPTH, bins=RF_BINS, adapter_fit_wall_s=rf_wall, direct_fit_wall_s=direct_rf_wall,
                         predictions_vs_direct=int(np.sum(pred9 != np.asarray(direct_rf.predict(x9n)))),
                         **_sp_same_splits(f, direct_rf._forest))

    # Configs 11 and 7: kNN (k = 10) and ANN (ivfflat, nlist 1024, nprobe 32).
    items = torch.randn((SP_NB_N, NB_D), generator=gen, device="cuda", dtype=torch.float64).cpu().numpy()
    q = torch.randn((SP_NB_Q, NB_D), generator=gen, device="cuda", dtype=torch.float64).cpu().numpy()
    dfi, dfq = _sp_df(spark, items), _sp_df(spark, q)
    items_t = torch.from_numpy(items).cuda()
    for name, make, direct_make in (
        ("knn_config11", lambda: A.TpuNearestNeighbors(k=NB_K),
         lambda: NearestNeighbors().setK(NB_K)),
        ("ann_config7", lambda: A.TpuApproximateNearestNeighbors(k=NB_K).setAlgorithm("ivfflat")
         .setAlgoParams({"nlist": NB_LISTS, "nprobe": NB_PROBE}),
         lambda: ApproximateNearestNeighbors().setK(NB_K).setAlgorithm("ivfflat")
         .setAlgoParams({"nlist": NB_LISTS, "nprobe": NB_PROBE})),
    ):
        model, wall, _ = _sp_fit(sp, lambda: make().fit(dfi))
        direct, direct_wall = _sp_wall(lambda: direct_make().fit(items_t))
        d, i = _sp_neighbours(model, dfq)
        # The direct model searches the same partition blocks the UDF does.
        dd = [direct.kneighbors(torch.from_numpy(b).cuda()) for b in _sp_chunks(q)]
        d_want = np.concatenate([a.cpu().numpy() for a, _ in dd])
        i_want = np.concatenate([b.cpu().numpy() for _, b in dd])
        out[name] = {"items": [SP_NB_N, NB_D, "float64"], "queries": SP_NB_Q, "k": NB_K,
                     "adapter_fit_wall_s": wall, "direct_fit_wall_s": direct_wall,
                     "indices_differ": int(np.sum(i != i_want)),
                     "distances_max_abs": float(np.abs(d - d_want).max())}

    # Config 12: DBSCAN, eps 2.0, minSamples 8, 20 planted blobs.
    centres = 12.0 * torch.randn((DB_BLOBS, DB_D), generator=gen, device="cuda")
    x12 = dbscan_blobs(SP_DB_N, centres, gen).double().cpu().numpy()
    df12 = _sp_df(spark, x12)
    db, db_wall, _ = _sp_fit(sp, lambda: A.TpuDBSCAN().setEps(DB_EPS).setMinSamples(DB_MIN_SAMPLES).fit(df12))
    direct_db, direct_db_wall = _sp_wall(
        lambda: DBSCAN().setEps(DB_EPS).setMinSamples(DB_MIN_SAMPLES).fit(torch.from_numpy(x12).cuda()))
    lab = _sp_column(db, df12, "prediction")
    out["dbscan_config12"] = {"x": [SP_DB_N, DB_D, "float64"], "adapter_fit_wall_s": db_wall,
                              "direct_fit_wall_s": direct_db_wall,
                              "labels_differ": int(np.sum(db.labels_ != direct_db.labels_)),
                              "transform_differ": int(np.sum(lab != direct_db.labels_)),
                              "clusters": int(len(set(db.labels_.tolist()) - {-1}))}
    emit(out)
    fo = out["forest"]
    require(fo["predictions_vs_direct"] == 0 and fo["gain_max_abs"] <= 1e-6 and fo["same_feature_share"] >= 0.95
            and fo["threshold_max_abs_same_feature"] <= 1e-6, f"(r-e) forest against the direct fit: {fo}")
    for name in ("knn_config11", "ann_config7"):
        r = out[name]
        require(r["indices_differ"] == 0 and r["distances_max_abs"] <= (1e-10 if name.startswith("knn") else 1e-5),
                f"(r-e) {name} against the direct fit: {r}")
    dbo = out["dbscan_config12"]
    require(dbo["labels_differ"] == 0 and dbo["transform_differ"] == 0, f"(r-e) DBSCAN: {dbo}")
    return out


def phase_spark_umap(sp: dict, gen: torch.Generator) -> dict:
    """(f) ``TpuUMAP`` at config 13, uncut (50,000 x 64 -> 2-D): K4's
    launch count read just around the adapter's fit, the layout bitwise a
    direct port fit of the collected rows, training rows transformed to
    their fitted coordinates."""
    A, spark = sp["adapter"], sp["spark"]
    truth = UM_SCALE * torch.randn((UM_BLOBS, UM_D), generator=gen, device="cuda")
    x, _ = umap_blobs(UM_N, truth, gen)
    xn = x.double().cpu().numpy()
    df = _sp_df(spark, xn)

    def est(e):
        return e.setNNeighbors(UM_K).setNComponents(UM_DIM).setNEpochs(UM_EPOCHS).setSeed(SEED) \
            .setBuildAlgo("brute_approx")

    model, wall, counts = _sp_fit(sp, lambda: est(A.TpuUMAP()).fit(df))
    launches = counts["tail_accumulate"]
    direct, direct_wall = _sp_wall(lambda: est(UMAP()).fit(torch.from_numpy(xn).cuda()))
    emb = _sp_column(model, df, "embedding")
    out = {"phase": "spark_umap", "config": "BASELINE config 13", "x": [UM_N, UM_D, "float64"],
           "epochs": UM_EPOCHS, "k4_launches": launches, "adapter_fit_wall_s": wall, "direct_fit_wall_s": direct_wall,
           "layout_bitwise_direct": np.asarray(model.embedding).tobytes() == np.asarray(direct.embedding).tobytes(),
           "transform_fitted_exact": bool(np.array_equal(emb, np.asarray(model.embedding, dtype=np.float64))),
           "card": sp["card"]}
    emit(out)
    require(launches == UM_EPOCHS, f"(r-f) the adapter's UMAP fit launched K4 {launches} times, not {UM_EPOCHS}")
    require(out["layout_bitwise_direct"], "(r-f) the adapter's layout differs from the direct fit's")
    require(out["transform_fitted_exact"], "(r-f) training rows did not transform to their fitted coordinates")
    return {"out": out, "launches": launches}


def phase_spark_barrier(sp: dict, logistic: dict, tmp: str) -> dict:
    """(g) ``barrier.attempt=1`` relaunches the stage and the refit is
    bitwise (d)'s; a checkpointed ``gang_fit`` of config 4's elastic net
    killed mid-solve (a fault at its third segment boundary) resumes to
    the uninterrupted result."""
    A, spark = sp["adapter"], sp["spark"]
    from spark_rapids_ml_tpu_torch.spark.barrier import gang_fit

    df = logistic["df"]
    with inject("barrier.attempt=1") as plan:
        refit, wall, _ = _sp_fit(sp, lambda: A.TpuLogisticRegression().setMaxIter(100).setRegParam(0.01).fit(df))
    first = logistic["model"]._core
    relaunch = {"fired": [list(f) for f in plan.fired], "wall_s": wall,
                "bitwise": (refit._core.coefficients.tobytes() == first.coefficients.tobytes()
                            and refit._core.intercept == first.intercept)}
    x, y = logistic["x"], logistic["y"]
    yl = x @ np.linspace(-1.0, 1.0, GLM_D) + 0.1 * np.random.default_rng(SP_SEED).normal(size=x.shape[0])
    rdd = _sp_df(spark, x, yl, parts=1).select("features", "label").rdd

    def enet():
        return LinearRegression(uid="spark-enet").setRegParam(0.1).setElasticNetParam(0.5)

    os.environ["TPUML_CHECKPOINT_EVERY"] = str(SP_CKPT_EVERY)
    try:
        whole, whole_wall, _ = _sp_fit(sp, lambda: gang_fit(enet(), rdd, labeled=True,
                                                      checkpoint_dir=os.path.join(tmp, "ck-whole"))[0])
        clear_counters("checkpoint")
        with inject("checkpoint.segment=1@2") as plan2:
            resumed, resumed_wall, _ = _sp_fit(sp, lambda: gang_fit(enet(), rdd, labeled=True,
                                                              checkpoint_dir=os.path.join(tmp, "ck-kill"))[0])
    finally:
        del os.environ["TPUML_CHECKPOINT_EVERY"]
    resume = {"fired": [list(f) for f in plan2.fired], "uninterrupted_wall_s": whole_wall,
              "resumed_wall_s": resumed_wall, "restores": counter_value("checkpoint.restore"),
              "restored_steps": counter_value("checkpoint.restore.steps"),
              "bitwise": (resumed.coefficients.tobytes() == whole.coefficients.tobytes()
                          and resumed.intercept == whole.intercept)}
    out = {"phase": "spark_barrier", "relaunch": relaunch, "resume": resume, "card": sp["card"]}
    emit(out)
    require(relaunch["fired"] == [["barrier.attempt", 0]] and relaunch["bitwise"], f"(r-g) relaunch: {relaunch}")
    require(resume["fired"] == [["checkpoint.segment", 2]] and resume["restores"] >= 1
            and resume["restored_steps"] >= 1 and resume["bitwise"], f"(r-g) resume: {resume}")
    return out


@contextlib.contextmanager
def pyspark_stub():
    """The repo's pyspark stub (``tests/pyspark_stub``) first on
    ``sys.path`` for the block, and the port's adapter imported against
    it; ``sys.path`` and ``sys.modules`` are restored after."""
    import importlib

    stub = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "pyspark_stub")
    saved = {n: m for n, m in sys.modules.items() if n.startswith("pyspark")}
    for n in saved:
        del sys.modules[n]
    sys.path.insert(0, stub)
    was = sys.modules.pop("spark_rapids_ml_tpu_torch.spark.adapter", None)
    try:
        adapter = importlib.import_module("spark_rapids_ml_tpu_torch.spark.adapter")
        require(adapter.HAS_PYSPARK, "the pyspark stub did not import as pyspark")
        yield adapter
    finally:
        sys.path.remove(stub)
        for n in [n for n in sys.modules if n.startswith("pyspark")]:
            del sys.modules[n]
        sys.modules.update(saved)
        sys.modules.pop("spark_rapids_ml_tpu_torch.spark.adapter", None)
        if was is not None:
            sys.modules["spark_rapids_ml_tpu_torch.spark.adapter"] = was


def spark_phases(card: str) -> dict:
    """Group (r), the Spark layer through the repo's pyspark stub, within
    ``SP_WALL_LIMIT_S``: (a) resources and ``bringup_executor``; (b)
    config 5's PCA; (c) config 3's KMeans and config 4's linear
    regression; (d) config 10's logistic regression through ``gang_fit``;
    (e) config 9's forest, configs 11 and 7's kNN and ANN, config 12's
    DBSCAN; (f) config 13's UMAP, K4 200 times; (g) the barrier relaunch
    and a checkpointed gang fit resumed mid-solve. Its own seed."""
    import importlib.util

    t0 = time.perf_counter()
    require(importlib.util.find_spec("pandas") is not None,
            "(r) needs pandas: the stub's pandas_udf runs every adapter transform")
    import pandas

    emit({"phases": "spark", "pandas": pandas.__version__, "transforms": "the stub's pandas_udf"})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SP_SEED)
    with tempfile.TemporaryDirectory(prefix="spark-") as tmp, pyspark_stub() as adapter:
        from pyspark.sql import SparkSession

        spark = SparkSession.builder.master("local[4]").getOrCreate()
        sp = {"adapter": adapter, "card": card,
              "spark": spark, "launches": dict.fromkeys(_sp_launches(), 0)}
        res = {"a": phase_spark_resources(sp, tmp)}
        res["b"] = phase_spark_pca(sp, gen)
        res["c"] = phase_spark_kmeans_linear(sp, gen)
        logistic = phase_spark_logistic(sp, gen)
        res["d"] = logistic["out"]
        res["e"] = phase_spark_neighbours(sp, gen)
        umap = phase_spark_umap(sp, gen)
        res["f"] = umap["out"]
        res["g"] = phase_spark_barrier(sp, logistic, tmp)
    wall = time.perf_counter() - t0
    emit({"phases": "spark", "card": card, "wall_s": wall, "adapter_fit_launches": sp["launches"]})
    require(wall <= SP_WALL_LIMIT_S, f"the spark phases took {wall:.1f} s, over their {SP_WALL_LIMIT_S:.0f} s")
    res["launches"] = sp["launches"]
    return res


# --- (s) the distributed serving tier: config 18, a hot swap, the sharded
# route, the controller over a router, an elastic episode ----------------

# Config 18 (benchmarks/config18_router.py), uncut: KMeans k = 32 over 64
# features, 8 closed-loop threads x 40 requests x 64 rows, max_batch 8,
# max_delay 1 ms, buckets (64, 512) warmed, gangs of 1, 2 and 4 members
# on the one card. The centres and rows are dyadic (integers over 4), so
# every distance is exact in float64 and a routed answer is bitwise the
# model's own predict.
RT_WALL_LIMIT_S = 120.0
RT_SEED = 18
RT_THREADS = 8
RT_REQUESTS = 40
RT_ROWS = 64
RT_D = 64
RT_K = 32
RT_MAX_BATCH = 8
RT_DELAY_MS = 1.0
RT_SWEEP = (1, 2, 4)
RT_SCALING_BOUND = 3.0      # the reference's 4-vs-1 bound where 4 CPUs exist: recorded, not gated
RT_FLOOR = 0.4              # the reference's non-collapse floor: gated
RT_TIMEOUT_S = 60.0         # the router's connect/ack wait and each member's accept timeout
RT_MEM_BUDGET = 1 << 20     # (b)-(e) gang: bytes each member admits, so (c)'s request sheds everywhere
RT_BIG = 16_387             # (c): rows of the oversized request (4 shards do not divide it)
RT_SWAP_THREADS = 16        # (b): config 16's closed loop of single rows
RT_SWAP_REQUESTS = 60
RT_PCA_N = 262_144          # (d): config 5's fresh rows, as group (g)'s
RT_PCA_TOL = 1e-12          # (d): routed transform against the model's, relative to the largest value


def rt_model(rng) -> KMeansModel:
    return KMeansModel("bench-route", rng.integers(-16, 16, (RT_K, RT_D)) / 4.0)


def rt_router(workers: int, **kw):
    """A spawned gang on the card: each member is a ``--platform cuda``
    child of the router, started with config 18's batching knobs."""
    from spark_rapids_ml_tpu_torch.serving import RoutingRuntime

    return RoutingRuntime(workers=workers, launch="spawn", max_batch=RT_MAX_BATCH, max_delay_ms=RT_DELAY_MS,
                          queue_limit=4 * RT_THREADS * RT_REQUESTS, connect_timeout=RT_TIMEOUT_S, **kw)


def rt_closed_loop(rt, name: str, probes: np.ndarray):
    """``probes.shape[0]`` threads, one outstanding request each: the
    wall, every answer (by thread and request), and any error."""
    answers = [[None] * probes.shape[1] for _ in range(probes.shape[0])]
    errors = []

    def worker(tid: int) -> None:
        for j in range(probes.shape[1]):
            try:
                answers[tid][j] = rt.submit(name, probes[tid, j]).result(timeout=RT_TIMEOUT_S)
            except Exception as exc:  # noqa: BLE001 - counted and required below
                errors.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(probes.shape[0])]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads), "(s) a closed-loop thread did not finish")
    return wall, answers, errors


def phase_router_config18(gangs: dict, card: str) -> dict:
    """(s-a) Config 18's sweep: the same model and request stream through
    gangs of 1, 2 and 4 members on the one card (``gangs``: each router
    and the seconds it took to come up), each warmed, each closed after
    its run. Rows/s of each gang (host clock, closed loop), the scaling
    from 1 to 4, each member's completed count; every request completes,
    every member takes traffic, every answer is bitwise the model's own
    predict, and the scaling clears the reference's non-collapse floor."""
    rng = np.random.default_rng(RT_SEED)
    model = rt_model(rng)
    probes = rng.integers(-16, 16, (RT_THREADS, RT_REQUESTS, RT_ROWS, RT_D)) / 4.0
    want = np.asarray(model.predict(probes.reshape(-1, RT_D))).reshape(RT_THREADS, RT_REQUESTS, RT_ROWS)
    total_rows = RT_THREADS * RT_REQUESTS * RT_ROWS
    runs = {}
    for workers in RT_SWEEP:
        rt, up_s = gangs[workers]
        try:
            rt.register("km", model, warm_buckets=(RT_ROWS, RT_THREADS * RT_ROWS))
            wall, answers, errors = rt_closed_loop(rt, "km", probes)
            snap = rt.snapshot()
        finally:
            rt.close()
        wrong = sum(1 for t in range(RT_THREADS) for j in range(RT_REQUESTS)
                    if answers[t][j] is None or answers[t][j].tobytes() != want[t, j].tobytes())
        completed = [m["completed"] for m in snap["members"]]
        runs[workers] = {"up_s": up_s, "wall_s": wall, "rows_per_s": total_rows / wall,
                         "completed": completed, "routed": [m["routed"] for m in snap["members"]],
                         "errors": len(errors), "not_bitwise": wrong}
    scaling = runs[4]["rows_per_s"] / runs[1]["rows_per_s"]
    cpus = len(os.sched_getaffinity(0))
    out = {"phase": "router_config18", "config": "benchmarks/config18_router.py", "model": [RT_K, RT_D],
           "threads": RT_THREADS, "requests": RT_REQUESTS, "rows": RT_ROWS, "max_batch": RT_MAX_BATCH,
           "max_delay_ms": RT_DELAY_MS, "gangs": runs, "scaling_4_over_1": scaling,
           "scaling_floor": RT_FLOOR, "reference_bound_4_cpus": RT_SCALING_BOUND,
           "reference_bound_met": scaling >= RT_SCALING_BOUND, "sched_getaffinity_cpus": cpus,
           "timing": "host clock, closed loop; the members share one card, the gangs not yet run idle beside",
           "card": card}
    emit(out)
    for workers, run in runs.items():
        require(run["errors"] == 0 and sum(run["completed"]) == RT_THREADS * RT_REQUESTS,
                f"(s-a) the {workers}-member gang completed {sum(run['completed'])}, {run['errors']} errors")
        require(min(run["completed"]) > 0, f"(s-a) a member of the {workers}-member gang got no traffic")
        require(run["not_bitwise"] == 0, f"(s-a) {run['not_bitwise']} answers of the {workers}-member gang "
                                          "differ from the model's predict")
    require(scaling >= RT_FLOOR, f"(s-a) the routing tier collapsed to {scaling:.2f}x (floor {RT_FLOOR})")
    return out


def phase_router_hot_swap(rt, card: str) -> dict:
    """(s-b) A version-atomic hot swap under load: config 16's model (KMeans
    k = 100 over 16 features, dyadic) served to 16 closed-loop threads of
    single rows by 2 members; v2 registers, warms on both members and
    takes the alias mid-stream. No request sheds or fails, every answer
    is bitwise the prediction of the version it is attributed to, and a
    local table keeps each (name, version)'s first and last reply. Each
    caller's versions run v1 then v2 (a caller's next request starts after
    its last reply); across callers, requests in flight at the flip may
    still answer v1 after v2's first reply, which the table counts."""
    rng = np.random.default_rng(RT_SEED + 1)
    m1 = KMeansModel("sw-v1", rng.integers(-64, 64, (KM_K, KM_D)) / 4.0)
    m2 = KMeansModel("sw-v2", rng.integers(-64, 64, (KM_K, KM_D)) / 4.0 + 8.0)
    total = RT_SWAP_THREADS * RT_SWAP_REQUESTS
    probes = rng.integers(-64, 64, (total, KM_D)) / 4.0
    exp = {1: np.asarray(m1.predict(probes)), 2: np.asarray(m2.predict(probes))}
    shed0 = counter_value("serving.router.shed") + counter_value("serving.router.rejected")
    rt.register("km16", m1, alias="prod", warm_buckets=(1, 16))
    t_start = time.perf_counter()
    replies, errors, lock = [], [], threading.Lock()
    started, swapped = threading.Event(), threading.Event()

    def worker(tid: int) -> None:
        local = []
        for j in range(RT_SWAP_REQUESTS):
            i = tid * RT_SWAP_REQUESTS + j
            try:
                fut = rt.submit("km16@prod", probes[i])
                ans = fut.result(timeout=RT_TIMEOUT_S)
                local.append((tid, i, time.perf_counter() - t_start, fut.model_name, fut.model_version, ans))
            except Exception as exc:  # noqa: BLE001 - required below
                errors.append(repr(exc))
            if tid == 0 and j == RT_SWAP_REQUESTS // 5:
                started.set()
            if tid == 0 and j == RT_SWAP_REQUESTS // 2:
                swapped.wait(timeout=RT_TIMEOUT_S)
        with lock:
            replies.extend(local)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(RT_SWAP_THREADS)]
    for t in threads:
        t.start()
    require(started.wait(timeout=RT_TIMEOUT_S), "(s-b) no request finished before the swap")
    t_swap0 = time.perf_counter()
    v2 = rt.register("km16", m2, warm_buckets=(1, 16)).version
    rt.set_alias("km16", "prod", v2, warm_buckets=(1, 16))
    swap_s = time.perf_counter() - t_swap0
    swapped.set()
    for t in threads:
        t.join(timeout=300)
    require(not any(t.is_alive() for t in threads), "(s-b) a submitting thread did not finish")
    table = {}
    for _, _, t_reply, name, version, _ in sorted(replies, key=lambda r: r[2]):
        row = table.setdefault(f"{name}@{version}", {"requests": 0, "first_s": t_reply, "last_s": t_reply})
        row["requests"] += 1
        row["last_s"] = t_reply
    wrong = sum(1 for _, i, _, _, v, ans in replies if ans.tobytes() != exp[v][i:i + 1].tobytes())
    by_caller = {}
    for tid, i, _, _, v, _ in sorted(replies, key=lambda r: r[1]):
        by_caller.setdefault(tid, []).append(v)
    monotone = all(seq == sorted(seq) for seq in by_caller.values())
    first_v2 = table.get("km16@2", {}).get("first_s", float("inf"))
    v1_after = sum(1 for _, _, t_reply, _, v, _ in replies if v == 1 and t_reply > first_v2)
    shed = counter_value("serving.router.shed") + counter_value("serving.router.rejected") - shed0
    out = {"phase": "router_hot_swap", "model": [KM_K, KM_D], "members": 2, "threads": RT_SWAP_THREADS,
           "requests": RT_SWAP_REQUESTS, "replies": len(replies), "errors": len(errors), "shed": shed,
           "not_its_versions_answer": wrong, "freshness": table, "each_caller_v1_then_v2": monotone,
           "v1_replies_after_v2_first": v1_after, "swap_s": swap_s, "card": card}
    emit(out)
    require(not errors and shed == 0 and len(replies) == total, f"(s-b) shed {shed}, errors {errors[:3]}")
    require(wrong == 0, f"(s-b) {wrong} answers are not their attributed version's")
    require(set(table) == {"km16@1", "km16@2"}, f"(s-b) versions served: {sorted(table)}")
    require(monotone, "(s-b) a caller saw v2 before v1")
    require(table["km16@1"]["first_s"] < first_v2, "(s-b) v2 answered before v1's first reply")
    return out


def phase_router_oversized(rt, card: str) -> dict:
    """(s-c) An oversized request: 16,387 rows of config 18's model, whose
    declared bytes exceed the budget every member admits
    (``RT_MEM_BUDGET``), so the router runs it on its sharded route,
    once on the default mesh (the one card) and once on a 4-shard mesh of
    the one card (16,387 rows pad to 16,388); each answer is bitwise the
    members' answers to the same rows in 64-row requests."""
    from spark_rapids_ml_tpu_torch.core.serving import bucket_rows
    from spark_rapids_ml_tpu_torch.serving.signature import spec_bytes

    rng = np.random.default_rng(RT_SEED + 2)
    model = rt_model(rng)
    mv = rt.register("big", model)
    x = rng.integers(-16, 16, (RT_BIG, RT_D)) / 4.0
    declared = bucket_rows(RT_BIG) * RT_D * 8 + spec_bytes(mv.signature.output_spec(bucket_rows(RT_BIG),
                                                                                    torch.float64))
    budgets = [m["mem_budget"] for m in rt.snapshot()["members"] if not m["dead"]]
    before = counter_value("serving.router.oversized")
    completed0 = sum(m["completed"] for m in rt.snapshot()["members"])
    t0 = time.perf_counter()
    whole = rt.submit("big", x).result(timeout=RT_TIMEOUT_S)
    whole_s = time.perf_counter() - t0
    old = rt._mesh
    with rt._mesh_lock:
        rt._mesh = make_mesh((4, 1), devices=[torch.device("cuda", 0)] * 4)
    try:
        t0 = time.perf_counter()
        four = rt.submit("big", x).result(timeout=RT_TIMEOUT_S)
        four_s = time.perf_counter() - t0
    finally:
        with rt._mesh_lock:
            rt._mesh = old
    oversized = counter_value("serving.router.oversized") - before
    member_done = sum(m["completed"] for m in rt.snapshot()["members"]) - completed0
    # The same rows as 64-row requests, a wave of max_batch at a time: a
    # wave's priced bytes stay inside the members' budget.
    t0 = time.perf_counter()
    chunks = [x[i:i + RT_ROWS] for i in range(0, RT_BIG, RT_ROWS)]
    parts = []
    for w in range(0, len(chunks), RT_MAX_BATCH):
        futs = rt.submit_many("big", chunks[w:w + RT_MAX_BATCH])
        parts += [f.result(timeout=RT_TIMEOUT_S) for f in futs]
    small = np.concatenate(parts)
    small_s = time.perf_counter() - t0
    out = {"phase": "router_oversized", "rows": RT_BIG, "declared_bytes": declared, "member_budgets": budgets,
           "oversized_routes": oversized, "member_requests_during": member_done,
           "sharded_wall_s": whole_s, "sharded_4_wall_s": four_s, "chunked_requests": len(chunks),
           "chunked_wall_s": small_s, "bitwise_default_mesh": whole.tobytes() == small.tobytes(),
           "bitwise_4_shards": four.tobytes() == small.tobytes(),
           "bitwise_model": whole.tobytes() == np.asarray(model.predict(x)).tobytes(), "card": card}
    emit(out)
    require(budgets and all(b == RT_MEM_BUDGET for b in budgets) and declared > RT_MEM_BUDGET,
            f"(s-c) budgets {budgets}, declared {declared}")
    require(oversized == 2 and member_done == 0, f"(s-c) routes {oversized}, member requests {member_done}")
    require(out["bitwise_default_mesh"] and out["bitwise_4_shards"] and out["bitwise_model"],
            "(s-c) the sharded answer differs from the members'")
    return out


def rt_pca_score(model, x, y) -> float:
    """Minus the mean squared reconstruction error of the held-out rows
    about their mean, in float64 on the card."""
    xt = torch.from_numpy(np.ascontiguousarray(x)).cuda()
    pc = torch.from_numpy(np.ascontiguousarray(model.pc)).cuda()
    b = xt - xt.mean(dim=0)
    r = b - (b @ pc) @ pc.T
    return -float((r * r).sum()) / x.shape[0]


def phase_router_controller(rt, card: str, tmp: str) -> dict:
    """(s-d) One ``LifecycleController.run_cycle`` over the 2-member router
    on config 5's PCA (1,024 features, k = 16): 262,144 fresh rows drawn
    on the card as group (g)'s, ingested (journaled host float64), refit
    by ``PCA.partial_fit``, whose host rows fold through K1's float64
    route on the card (its launches counted around the cycle), gated,
    registered, warmed on both members and flipped. Then 64 routed rows
    transform as the new model does, within ``RT_PCA_TOL``."""
    from spark_rapids_ml_tpu_torch.lifecycle import LifecycleController

    gen = torch.Generator(device="cuda")
    gen.manual_seed(RT_SEED + 3)
    x = planted(RT_PCA_N, D, gen)
    ctrl = LifecycleController(PCA().setK(K), rt, "pca5", score_fn=rt_pca_score,
                               directory=os.path.join(tmp, "controller"), warm_buckets=(RT_ROWS,))
    _reset_kernel_launches()
    sync()
    t0 = time.perf_counter()
    outcome = ctrl.run_cycle(x)
    sync()
    cycle_s = time.perf_counter() - t0
    launches = {"centered_gram": k1.launches, **kk.launches, **k4.launches}
    del x
    torch.cuda.empty_cache()
    probe = planted(RT_ROWS, D, gen).double().cpu().numpy()
    fut = rt.submit("pca5@prod", probe)
    routed = fut.result(timeout=RT_TIMEOUT_S)
    local = np.asarray(ctrl.model.transform(probe))
    scale = float(np.abs(local).max())
    err = float(np.abs(routed - local).max())
    members = [st["snapshot"]["models"]["pca5"] for st in rt.member_status()]
    out = {"phase": "router_controller", "config": "BASELINE config 5 width", "rows": RT_PCA_N, "d": D, "k": K,
           "outcome": [outcome.cycle, outcome.action, outcome.version], "candidate_score": outcome.candidate_score,
           "cycle_wall_s": cycle_s, "refit_launches": launches, "router_aliases": rt.registry.aliases("pca5"),
           "member_aliases": [m["aliases"] for m in members], "routed_version": fut.model_version,
           "routed_vs_model_max_abs": err, "routed_vs_model_rel": err / max(scale, 1e-300),
           "routed_bitwise": routed.tobytes() == local.tobytes(), "card": card}
    emit(out)
    require((outcome.action, outcome.version) == ("flipped", 1), f"(s-d) the cycle ended {out['outcome']}")
    require(launches["centered_gram"] >= 1, f"(s-d) the refit launched K1 {launches['centered_gram']} times")
    require(out["router_aliases"] == {"prod": 1} and all(a == {"prod": 1} for a in out["member_aliases"]),
            f"(s-d) aliases {out['router_aliases']} / {out['member_aliases']}")
    require(fut.model_version == 1 and out["routed_vs_model_rel"] <= RT_PCA_TOL,
            f"(s-d) routed transform {err} from the model's (scale {scale})")
    return {"out": out, "launches": launches}


def phase_router_elastic(rt, card: str) -> dict:
    """(s-e) An ``ElasticScaler`` episode on the gang under single-row
    load: one join (the scaler's scale-up on a shed vote) and one retire
    (its scale-down on sustained idle), shedding nothing and every answer
    bitwise; then a member joined with ``ipc.recv=always@K:stall`` (K its
    replayed frames, so it freezes on its first routed request) is
    retired by ``retire_stalled`` through the scaler's liveness tick
    before its socket closes, and the requests parked on it complete
    elsewhere."""
    from spark_rapids_ml_tpu_torch.serving import ElasticScaler
    from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter

    rng = np.random.default_rng(RT_SEED + 4)
    model = rt_model(rng)
    rt.register("el", model, warm_buckets=(1,))
    probes = rng.integers(-16, 16, (400, RT_D)) / 4.0
    want = np.asarray(model.predict(probes))
    shed0 = counter_value("serving.router.shed") + counter_value("serving.router.rejected")
    stop, errors, served, lock = threading.Event(), [], [0], threading.Lock()
    wrong = [0]

    def pound(tid: int) -> None:
        i = tid
        while not stop.is_set():
            try:
                ans = rt.submit("el", probes[i % 400]).result(timeout=RT_TIMEOUT_S)
                with lock:
                    served[0] += 1
                    wrong[0] += ans.tobytes() != want[i % 400:i % 400 + 1].tobytes()
            except Exception as exc:  # noqa: BLE001 - required below
                errors.append(repr(exc))
            i += 4

    scaler = ElasticScaler(rt, min_members=2, max_members=3, hysteresis=1, cooldown_ms=0.0, high=1e9, low=-1.0)
    threads = [threading.Thread(target=pound, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    try:
        t0 = time.perf_counter()
        bump_counter("serving.router.shed")  # one shed vote: the scaler joins a member
        up = scaler.tick()
        join_s = time.perf_counter() - t0
        live_after_join = rt.live_member_ids()
        shed0 += 1
        time.sleep(0.5)
        scaler.low = 1e9  # sustained idle: the scaler retires the least-loaded member
        t0 = time.perf_counter()
        down = scaler.tick()
        retire_s = time.perf_counter() - t0
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=RT_TIMEOUT_S)
    live_after_retire = rt.live_member_ids()
    shed = counter_value("serving.router.shed") + counter_value("serving.router.rejected") - shed0

    # The stall: arm only the joiner, which inherits the environment.
    spec = f"ipc.recv=always@{1 + len(rt._oplog)}:stall"
    os.environ["TPUML_FAULTS"] = spec
    try:
        stalled = rt.add_member()
    finally:
        del os.environ["TPUML_FAULTS"]
    futs = [rt.submit("el", probes[i]) for i in range(12)]
    stall_scaler = ElasticScaler(rt, min_members=1, max_members=4, hysteresis=1000, cooldown_ms=0.0,
                                 stall_after_s=1.0)
    t0 = time.perf_counter()
    action = None
    while action is None and time.perf_counter() - t0 < 30.0:
        action = stall_scaler.tick()
        time.sleep(0.05)
    stall_s = time.perf_counter() - t0
    parked_ok = all(f.result(timeout=RT_TIMEOUT_S).tobytes() == want[i:i + 1].tobytes() for i, f in enumerate(futs))
    snap = {m["member"]: m for m in rt.snapshot()["members"]}
    out = {"phase": "router_elastic", "decisions": scaler.decisions, "join_s": join_s, "retire_s": retire_s,
           "live_after_join": live_after_join, "live_after_retire": live_after_retire, "served": served[0],
           "errors": len(errors), "shed": shed, "not_bitwise": wrong[0], "stall_spec": spec,
           "stalled_member": stalled, "stall_decisions": [list(map(str, d)) for d in stall_scaler.decisions],
           "stall_detect_s": stall_s, "stalled_dead": snap[stalled]["dead"], "parked_requests_ok": parked_ok,
           "card": card}
    emit(out)
    require(up == "scale_up" and down == "scale_down" and len(live_after_join) == 3
            and len(live_after_retire) == 2, f"(s-e) decisions {scaler.decisions}")
    require(not errors and shed == 0 and wrong[0] == 0 and served[0] > 0,
            f"(s-e) shed {shed}, errors {errors[:3]}, not bitwise {wrong[0]}")
    require(action == "stall_retire" and stall_scaler.decisions == [("stall_retire", (stalled,))]
            and snap[stalled]["dead"] and parked_ok, f"(s-e) the stall: {out['stall_decisions']}")
    return out


def router_phases(card: str) -> dict:
    """Group (s), the distributed serving tier on the card, within
    ``RT_WALL_LIMIT_S``: four gangs come up together (members start in
    parallel), then (a) config 18's sweep over the gangs of 1, 2 and 4
    members; then on the other, a 2-member gang whose members admit
    ``RT_MEM_BUDGET`` bytes each: (e) an ``ElasticScaler`` join, retire
    and stall retire (first, while its op log is short, so a join replays
    little), (b) a hot swap under config 16's closed loop, (c) an
    oversized request on the sharded route, (d) a ``LifecycleController``
    cycle on config 5's PCA (K1 in the refit). Members are spawned on
    ``cuda`` with the router's platform; every member exits when its
    router closes, or after ``RT_TIMEOUT_S`` without one."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    prev = os.environ.get("TPUML_ROUTER_CONNECT_TIMEOUT")
    os.environ["TPUML_ROUTER_CONNECT_TIMEOUT"] = str(RT_TIMEOUT_S)

    def up(workers: int, **kw):
        t = time.perf_counter()
        rt = rt_router(workers, **kw)
        return rt, time.perf_counter() - t

    pending = {}
    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            pending = {w: pool.submit(up, w) for w in RT_SWEEP}
            pending["g"] = pool.submit(up, 2, mem_budget=RT_MEM_BUDGET)
        gangs = {key: fut.result() for key, fut in pending.items()}
        emit({"phase": "router_up", "up_s": {str(k): v[1] for k, v in gangs.items()},
              "wall_s": time.perf_counter() - t0, "card": card})
        res = {"a": phase_router_config18(gangs, card)}
        rt = gangs["g"][0]
        with tempfile.TemporaryDirectory(prefix="router-") as tmp:
            res["e"] = phase_router_elastic(rt, card)
            res["b"] = phase_router_hot_swap(rt, card)
            res["c"] = phase_router_oversized(rt, card)
            ctrl = phase_router_controller(rt, card, tmp)
            res["d"] = ctrl["out"]
    finally:
        for fut in pending.values():
            if fut.done() and fut.exception() is None:
                fut.result()[0].close()
        if prev is None:
            os.environ.pop("TPUML_ROUTER_CONNECT_TIMEOUT", None)
        else:
            os.environ["TPUML_ROUTER_CONNECT_TIMEOUT"] = prev
    wall = time.perf_counter() - t0
    emit({"phases": "router", "card": card, "wall_s": wall, "refit_launches": ctrl["launches"]})
    require(wall <= RT_WALL_LIMIT_S, f"the router phases took {wall:.1f} s, over their {RT_WALL_LIMIT_S:.0f} s")
    res["launches"] = ctrl["launches"]
    return res


# --- (t) the sharded families in a gang of two processes on the one card ----

GS_RANKS = 2
GS_WALL_LIMIT_S = 120.0
GS_RANK_TIMEOUT_S = 90
GS_SEED = SEED + 1100       # the group's data: drawn anew from its own seed, alike in every process
GS_UMAP_DEFAULT = "config13_umap/"  # the default-mode UMAP fit: its scatter's atomics order each run anew
GS_TRUST_TOL = 0.03         # its trustworthiness against the (2, 1) fit's (the UMAP main path's bar)


def gs_data() -> dict:
    """The group's whole matrices, drawn on the card from ``GS_SEED`` (every
    process draws the same bits): config 11's 1M x 96 items and 10,000
    queries (config 7's too), config 13's 50,000 x 64 blobs, config 12's
    100,000 x 16 blobs and config 9's 500,000 x 16 rows."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(GS_SEED)
    dev = gen.device
    items = torch.randn((NB_N, NB_D), generator=gen, device=dev)
    queries = torch.randn((NB_Q, NB_D), generator=gen, device=dev)
    truth = torch.randn((UM_BLOBS, UM_D), generator=gen, device=dev) * UM_SCALE
    x_umap, _ = umap_blobs(UM_N, truth, gen)
    centres = torch.randn((DB_BLOBS, DB_D), generator=gen, device=dev) * 12.0
    x_db = dbscan_blobs(DB_N, centres, gen)
    xf, margin = forest_rows(gen)
    return {"items": items, "queries": queries, "x_umap": x_umap, "x_db": x_db, "xf": xf, "margin": margin}


def gs_fits(setup, in_gang: bool, data: dict) -> tuple:
    """Two fits of each family on the group's data, its estimator set up by
    ``setup`` (the gang's deploy mode, or the parent's (2, 1) mesh): the
    first pays a fresh process's first calls (kernel loading, cuBLAS
    set-up, JIT-compiled elementwise kernels), the second is the steady
    fit. Returns (the second fit's results as host arrays keyed
    ``family/what``, each family's two walls (host clock around the fit
    and a synchronize), the bytes the second fit gathered (counter
    ``collectives.gather.bytes``), whether each family's two fits agree
    bit for bit). In the gang, config 7's ``ivfflat`` fit records its
    refusal. UMAP fits twice over: ``config13_umap`` in the default mode
    users run, whose epoch scatter (an ``index_add_``) orders its float
    atomics anew each run, then ``config13_umap_deterministic``, a labelled
    second pass under ``torch.use_deterministic_algorithms``."""
    res, walls, gathered, repeat = {}, {}, {}, {}

    def host(out: dict) -> dict:
        return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in out.items()}

    def run(name, fn):
        fits = []
        for _ in range(2):
            before = counter_value("collectives.gather.bytes")
            sync()
            t = time.perf_counter()
            out = fn()
            sync()
            fits.append((time.perf_counter() - t, host(out)))
            gathered[name] = counter_value("collectives.gather.bytes") - before
        walls[name] = {"first": fits[0][0], "second": fits[1][0]}
        repeat[name] = all(np.array_equal(_bits(fits[0][1][k]), _bits(v)) for k, v in fits[1][1].items())
        res.update({f"{name}/{k}": v for k, v in fits[1][1].items()})

    def knn():
        d, i = setup(NearestNeighbors().setK(NB_K)).fit(data["items"]).kneighbors(data["queries"])
        return {"d": d, "i": i}

    def brute():
        est = ApproximateNearestNeighbors().setK(NB_K).setMetric("sqeuclidean").setAlgorithm("brute")
        d, i = setup(est).fit(data["items"]).kneighbors(data["queries"])
        return {"d": d, "i": i}

    def umap():
        return {"embedding": setup(umap_estimator()).fit(data["x_umap"])._emb_raw}

    def umap_deterministic():
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                return umap()
        finally:
            torch.use_deterministic_algorithms(False)

    def dbscan():
        model = setup(DBSCAN().setEps(DB_EPS).setMinSamples(DB_MIN_SAMPLES)).fit(data["x_db"])
        return {"labels": model.labels_, "core": model.core_mask_}

    def forests():
        y = (data["margin"] > 0).to(torch.float32)
        clf = setup(RandomForestClassifier().setNumTrees(RF_TREES).setMaxDepth(RF_DEPTH).setMaxBins(RF_BINS)
                    .setNumClasses(2).setSeed(SEED)).fit((data["xf"], y))
        reg = setup(RandomForestRegressor().setNumTrees(RF_TREES).setMaxDepth(RF_DEPTH).setMaxBins(RF_BINS)
                    .setSeed(SEED)).fit((data["xf"], data["margin"]))
        out = {f"classifier_{f}": t for f, t in zip(clf._forest._fields, clf._forest)}
        out.update({f"regressor_{f}": t for f, t in zip(reg._forest._fields, reg._forest)})
        return out

    run("config11_knn", knn)
    run("config7_brute", brute)
    if in_gang:
        ivf = (ApproximateNearestNeighbors().setK(NB_K).setMetric("sqeuclidean").setAlgorithm("ivfflat")
               .setAlgoParams({"nlist": NB_LISTS, "nprobe": NB_PROBE}))
        try:
            setup(ivf).fit(data["items"])
            refusal = "fitted"
        except NotImplementedError as exc:
            refusal = str(exc)
        res["config7_ivfflat_refusal"] = np.asarray(refusal)
    run("config13_umap", umap)
    run("config13_umap_deterministic", umap_deterministic)
    run("config12_dbscan", dbscan)
    run("config9_forests", forests)
    return res, walls, gathered, repeat


def gs_rank_main(argv) -> int:
    """One rank of (t), started by :func:`gang_sharded_phases`: joins the
    2-rank gloo gang (CUDA tensors: NCCL refuses two ranks on one GPU),
    fits every family on the whole matrices with ``setDeployMode("gang")``
    and writes its results and K1-K4 launches to ``--gs-out``."""
    args = dict(zip(argv[1::2], argv[2::2]))
    rank, out_dir = int(args["--gs-rank"]), args["--gs-out"]
    port_device.set_platform("cuda")
    port_device.use_ieee_fp32_matmul()
    torch.backends.cudnn.allow_tf32 = False
    gang.initialize(coordinator_address=f"127.0.0.1:{args['--gs-port']}", backend="gloo")
    _reset_kernel_launches()
    t0 = time.perf_counter()
    res, walls, gathered, repeat = gs_fits(lambda est: est.setDeployMode("gang"), in_gang=True, data=gs_data())
    res["meta"] = np.asarray(json.dumps({"walls": walls, "gathered": gathered, "launches": _sp_launches(),
                                         "repeat_bitwise": repeat,
                                         "wall_s": time.perf_counter() - t0,
                                         "mesh": [gang.global_mesh().shape["data"], gang.process_count()]}))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()
    print(f"gang rank {rank}/{GS_RANKS} ok", flush=True)
    return 0


def _spawn_gs_ranks(out_dir: str) -> list:
    """Start (t)'s ranks (one per ``member_env``), wait for them under
    ``GS_RANK_TIMEOUT_S``, and stop any that outlive it."""
    with contextlib.closing(__import__("socket").socket()) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gs-rank", str(rank), "--gs-port", str(port),
                          "--gs-out", out_dir], env=gang.member_env(rank, GS_RANKS),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(GS_RANKS)
    ]
    try:
        outs = [p.communicate(timeout=GS_RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"(t) rank {rank}/{GS_RANKS} failed: {stderr[-2000:]}")
        require(f"gang rank {rank}/{GS_RANKS} ok" in stdout, f"(t) rank {rank}/{GS_RANKS} printed no result")
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(GS_RANKS)]


def _bits(a: np.ndarray) -> np.ndarray:
    """An array's bits: floats as unsigned integers of their width."""
    a = np.asarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}")) if a.dtype.kind == "f" else a


def gang_sharded_phases(card: str) -> dict:
    """Group (t), within ``GS_WALL_LIMIT_S``: two ranks on the one card
    (gloo with CUDA tensors), each holding the whole matrices, fit config
    11's kNN, config 7's ``brute`` (its ``ivfflat`` refused, as the
    reference's IVF build fails in a gang), config 13's UMAP (in the
    default mode, then a deterministic pass), config 12's DBSCAN and
    config 9's two forests with ``setDeployMode("gang")``, each twice; then
    this process fits the same on a (2, 1) mesh of the card. The ranks are
    bitwise equal. Each fit but the default-mode UMAP is bitwise the (2, 1)
    fit and its second fit bitwise its first; the default-mode UMAP, whose
    scatter sums in no fixed order, is held to the (2, 1) fit's
    trustworthiness within ``GS_TRUST_TOL``. Each rank's walls print beside
    the one-process walls, with the bytes each fit gathered; K1-K4 launch
    in no rank (``launches_gang``)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gang-sharded-") as tmp:
        ranks = _spawn_gs_ranks(tmp)
    spawn_wall = time.perf_counter() - t0
    meta = [json.loads(str(r.pop("meta"))) for r in ranks]
    refusal = [str(r.pop("config7_ivfflat_refusal")) for r in ranks]
    t = time.perf_counter()
    mesh = _mesh_of((2, 1))
    data = gs_data()
    single, single_walls, single_gathered, single_repeat = gs_fits(lambda est: est.setMesh(mesh), in_gang=False,
                                                                   data=data)
    single_wall = time.perf_counter() - t
    keys = sorted(single)
    exact = [k for k in keys if not k.startswith(GS_UMAP_DEFAULT)]
    same_ranks = {k: bool(np.array_equal(_bits(ranks[0][k]), _bits(ranks[1][k]))) for k in keys}
    same_single = {k: bool(np.array_equal(_bits(ranks[0][k]), _bits(single[k]))) for k in exact}
    families = list(single_walls)
    umap_key = GS_UMAP_DEFAULT + "embedding"
    sub_gen = torch.Generator(device="cuda")
    sub_gen.manual_seed(GS_SEED)
    sub = torch.randperm(UM_N, generator=sub_gen, device="cuda")[:UM_SUB]
    x_umap = data["x_umap"]
    umap_default = {
        "trustworthiness_gang": _umap_trust(x_umap, torch.from_numpy(ranks[0][umap_key]).cuda(), sub),
        "trustworthiness_one_process_2x1": _umap_trust(x_umap, torch.from_numpy(single[umap_key]).cuda(), sub),
        "max_abs_vs_one_process_2x1": float(np.abs(ranks[0][umap_key] - single[umap_key]).max()),
        "max_abs_vs_deterministic": float(np.abs(
            ranks[0][umap_key] - ranks[0]["config13_umap_deterministic/embedding"]).max()),
        "max_abs_y": float(np.abs(single[umap_key]).max()),
        "bitwise_one_process_2x1": bool(np.array_equal(_bits(ranks[0][umap_key]), _bits(single[umap_key]))),
    }
    out = {
        "phase": "gang_sharded", "card": card, "ranks": GS_RANKS, "backend": "gloo (CUDA tensors)",
        "mesh": meta[0]["mesh"],
        "walls_s": {f: {"gang_rank0": meta[0]["walls"][f], "gang_rank1": meta[1]["walls"][f],
                        "one_process_2x1": single_walls[f]} for f in families},
        "gather_bytes": {f: {"gang_rank0": meta[0]["gathered"][f], "one_process_2x1": single_gathered[f]}
                         for f in families},
        "rank_wall_s": [m["wall_s"] for m in meta], "spawn_to_exit_s": spawn_wall,
        "one_process_wall_s": single_wall,
        "launches_gang": [m["launches"] for m in meta],
        "ivfflat_refusal": refusal[0],
        "ranks_bitwise_equal": all(same_ranks.values()), "bitwise_one_process_2x1": all(same_single.values()),
        "umap_default_mode": umap_default,
        "repeat_bitwise": {"gang_rank0": meta[0]["repeat_bitwise"], "gang_rank1": meta[1]["repeat_bitwise"],
                           "one_process_2x1": single_repeat},
        "differing": sorted(k for k in keys if not (same_ranks[k] and same_single.get(k, True))),
        "dbscan_clusters": int(single["config12_dbscan/labels"].max()) + 1,
        "umap_finite": bool(np.isfinite(single[umap_key]).all() and np.isfinite(ranks[0][umap_key]).all()),
    }
    emit(out)
    require(set(keys) == set(ranks[0]) == set(ranks[1]), "(t) the ranks returned other results than one process")
    require(out["ranks_bitwise_equal"], f"(t) the ranks' results differ: {out['differing']}")
    require(out["bitwise_one_process_2x1"], f"(t) the gang differs from the (2, 1) fit: {out['differing']}")
    require(out["mesh"] == [GS_RANKS, GS_RANKS], f"(t) the gang's mesh {out['mesh']}")
    require(all(ok for r in out["repeat_bitwise"].values() for f, ok in r.items() if f + "/" != GS_UMAP_DEFAULT),
            f"(t) a family's second fit differs from its first: {out['repeat_bitwise']}")
    trust_gang, trust_single = umap_default["trustworthiness_gang"], umap_default["trustworthiness_one_process_2x1"]
    require(trust_gang > 0.85 and abs(trust_gang - trust_single) <= GS_TRUST_TOL,
            f"(t) the default-mode gang UMAP's trustworthiness {trust_gang:.4f} against the (2, 1) fit's "
            f"{trust_single:.4f} (within {GS_TRUST_TOL}, over 0.85)")
    for r in refusal:
        require(r.startswith(f"the mesh IVF build in a gang of {GS_RANKS} processes is refused"),
                f"(t) ivfflat in the gang: {r}")
    for m in meta:
        require(all(v == 0 for v in m["launches"].values()), f"(t) a kernel launched in the gang: {m['launches']}")
        require(all(m["gathered"][f] > 0 for f in ("config11_knn", "config7_brute", "config12_dbscan")),
                f"(t) a gathering family gathered nothing: {m['gathered']}")
    require(out["dbscan_clusters"] > 1 and out["umap_finite"], "(t) the fits' output is degenerate")
    wall = time.perf_counter() - t0
    emit({"phases": "gang_sharded", "card": card, "wall_s": wall})
    require(wall <= GS_WALL_LIMIT_S, f"the gang phases took {wall:.1f} s, over their {GS_WALL_LIMIT_S:.0f} s")
    return {"out": out, "launches": {name: sum(m["launches"][name] for m in meta) for name in meta[0]["launches"]}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run", file=sys.stderr)
        return 1
    port_device.set_platform("cuda")
    port_device.use_ieee_fp32_matmul()
    torch.backends.cudnn.allow_tf32 = False
    info = phase_device()
    peaks = peaks_for(info["name"])

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    guard0 = _guard_counts()
    x_big = planted(N_RAGGED, D, gen)
    check = phase_kernel_check(x_big, gen)
    torch.cuda.empty_cache()

    xm = x_big[:N_MAIN]
    parts = [x_big[i * HOST_ROWS:(i + 1) * HOST_ROWS].cpu().numpy() for i in range(HOST_PARTS)]
    main_path, model = phase_main_path(xm, parts)
    torch.cuda.empty_cache()
    times = phase_times(xm, model, peaks)
    phase_profile(xm)

    del x_big, xm, parts, model
    torch.cuda.empty_cache()
    km = kmeans_phases(gen, peaks)
    torch.cuda.empty_cache()
    um = umap_phases(gen, peaks)
    torch.cuda.empty_cache()
    streaming_phases(gen)
    torch.cuda.empty_cache()
    glm_phases(gen, peaks)
    # (e) With no budget set, the earlier phases' host-input fits were
    # admitted and nothing degraded, was refused or met an OOM.
    guard = _delta(guard0)
    emit({"phase": "fit_guard", "e": guard})
    require(guard["fit.admission.admitted"] == HOST_INPUT_FITS and guard["fit.admission.degraded"] == 0
            and guard["fit.admission.rejected"] == 0 and guard["fit.oom.events"] == 0,
            f"(e) the earlier phases' fits were not all admitted: {guard}")
    torch.cuda.empty_cache()
    fit_policy_phases(gen)
    torch.cuda.empty_cache()
    neighbour_phases(gen, peaks)
    torch.cuda.empty_cache()
    dbscan_forest_phases(gen, peaks)
    torch.cuda.empty_cache()
    composition_phases(gen)
    torch.cuda.empty_cache()
    serving_phases(gen)
    torch.cuda.empty_cache()
    mesh_phases(gen)
    torch.cuda.empty_cache()
    sharded_phases()
    torch.cuda.empty_cache()
    robustness_phases()
    torch.cuda.empty_cache()
    lifecycle_phases()
    torch.cuda.empty_cache()
    observability_phases(info["nvidia_smi"])
    torch.cuda.empty_cache()
    costs_phases(info["nvidia_smi"])
    torch.cuda.empty_cache()
    opsplane_phases(info["nvidia_smi"])
    torch.cuda.empty_cache()
    spark = spark_phases(info["nvidia_smi"])
    torch.cuda.empty_cache()
    router = router_phases(info["nvidia_smi"])
    torch.cuda.empty_cache()
    gang_sharded = gang_sharded_phases(info["nvidia_smi"])

    k1_f32 = times["k1_f32"]
    measured = {
        "centered_gram": dict(k1_f32, launches=main_path["launches"]["centered_gram"],
                              max_abs_err=check["main_max_abs_err"]),
    }
    for name in ("assign_stats_fused", "assign_stats_packed"):
        measured[name] = dict(km["times"][name], launches=km["main_path"]["launches"][name],
                              max_abs_err=km["check"]["main_max_abs_err"][name])
    measured["tail_accumulate"] = dict(um["times"]["tail_accumulate"],
                                       launches=um["main_path"]["launches"]["tail_accumulate"],
                                       max_abs_err=um["check"]["k4_vs_plain_max_abs"])
    rows = []
    for name, route, source, replaces in KERNELS:
        m = measured[name]
        rows.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": m["launches"], "launches_spark": spark["launches"][name],
            "launches_serving": router["launches"][name], "launches_gang": gang_sharded["launches"][name],
            "max_abs_err": m["max_abs_err"],
            "ms": m["kernel_ms"], "kernel_ms": m["kernel_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        })
    emit({"kernels": rows})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    if "--mesh-rank" in sys.argv:
        sys.exit(mesh_rank_main(sys.argv))
    if "--robust-child" in sys.argv:
        sys.exit(robust_child_main(sys.argv))
    if "--lifecycle-child" in sys.argv:
        sys.exit(lifecycle_child_main(sys.argv))
    if "--obs-rank" in sys.argv:
        sys.exit(obs_rank_main(sys.argv))
    if "--obs-child" in sys.argv:
        sys.exit(obs_child_main(sys.argv))
    if "--tune-child" in sys.argv:
        sys.exit(tune_child_main(sys.argv))
    if "--opsplane-child" in sys.argv:
        sys.exit(opsplane_child_main(sys.argv))
    if "--spark-child" in sys.argv:
        sys.exit(spark_child_main(sys.argv))
    if "--gs-rank" in sys.argv:
        sys.exit(gs_rank_main(sys.argv))
    sys.exit(main())
