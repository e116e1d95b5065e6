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
- the fit policy, last, which adds no kernel (its UMAP fits count K4's
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
  explicit twins.

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

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
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
from spark_rapids_ml_tpu_torch.clustering import KMeans, KMeansModel  # noqa: E402
from spark_rapids_ml_tpu_torch.ops import kmeans as ops_kmeans  # noqa: E402
from spark_rapids_ml_tpu_torch.utils.testing import kmeans_stats_f64, trustworthiness  # noqa: E402
from spark_rapids_ml_tpu_torch.manifold import UMAP, UMAPModel  # noqa: E402
from spark_rapids_ml_tpu_torch.models.umap import _knn_excluding_self  # noqa: E402
from spark_rapids_ml_tpu_torch.ops import umap as ops_umap  # noqa: E402
from spark_rapids_ml_tpu_torch.ops.kernels import umap as k4  # noqa: E402
from spark_rapids_ml_tpu_torch.ops.eigh import sign_flip  # noqa: E402
from spark_rapids_ml_tpu_torch.ops.randomized import draw_omega, randomized_pca  # noqa: E402
from spark_rapids_ml_tpu_torch.utils.tracing import counter_value  # noqa: E402
from spark_rapids_ml_tpu_torch.regression import LinearRegression  # noqa: E402
from spark_rapids_ml_tpu_torch.classification import LogisticRegression  # noqa: E402
from spark_rapids_ml_tpu_torch import native  # noqa: E402
from spark_rapids_ml_tpu_torch.core import membudget  # noqa: E402
from spark_rapids_ml_tpu_torch.core.data import HostArrayBlockReader  # noqa: E402
from spark_rapids_ml_tpu_torch.robustness.degrade import DegradationWarning  # noqa: E402

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
        # device time repeats that of the kernels it launched.
        if avg.device_type == DeviceType.CUDA and avg.self_device_time_total > 0:
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


def _device_ms_by_kernel(prof) -> dict:
    from torch.autograd import DeviceType

    device_ms = {}
    for avg in prof.key_averages():
        if avg.device_type == DeviceType.CUDA and avg.self_device_time_total > 0:
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
                                if avg.device_type.name == "CUDA" and avg.self_device_time_total > 0),
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


def f64_moments(x: torch.Tensor, y: torch.Tensor):
    """(XᵀX, Xᵀy, Σx, Σy, n) in float64 from row chunks of the same rows."""
    d = x.shape[1]
    xtx = torch.zeros((d, d), dtype=torch.float64, device=x.device)
    xty = torch.zeros(d, dtype=torch.float64, device=x.device)
    xs = torch.zeros(d, dtype=torch.float64, device=x.device)
    ys = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], F64_CHUNK):
        b, yb = x[i:i + F64_CHUNK].double(), y[i:i + F64_CHUNK].double()
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


def f64_stddev(x: torch.Tensor) -> torch.Tensor:
    """Population stddev of each column in float64, from row chunks."""
    chunks = range(0, x.shape[0], F64_CHUNK)
    mean = sum(x[i:i + F64_CHUNK].double().sum(dim=0) for i in chunks) / x.shape[0]
    ss = sum(((x[i:i + F64_CHUNK].double() - mean) ** 2).sum(dim=0) for i in chunks)
    return torch.sqrt(ss / x.shape[0])


def logistic_objective64(x: torch.Tensor, y: torch.Tensor, weights, intercepts, reg: float, sigma64) -> float:
    """The config's objective of an original-space solution, in float64 on
    the card: mean log-loss + reg/2 · Σ (w_j σ_j)² (the penalty on the
    standardized coefficients, σ the population stddev)."""
    w = torch.from_numpy(np.asarray(weights, dtype=np.float64)).to(x.device)
    b = torch.from_numpy(np.asarray(intercepts, dtype=np.float64)).to(x.device)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], F64_CHUNK):
        logits = x[i:i + F64_CHUNK].double() @ w + b
        yb = y[i:i + F64_CHUNK].long()
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
            "launches": m["launches"], "max_abs_err": m["max_abs_err"],
            "ms": m["kernel_ms"], "kernel_ms": m["kernel_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        })
    emit({"kernels": rows})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
