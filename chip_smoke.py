#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``spark_rapids_ml_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every hand-written kernel from ``spark_rapids_ml_tpu_torch/csrc``,
holds each against its plain PyTorch version and a float64 reference on
the card, drives the main path — ``PCA().setK(16)`` fit and transform on
a 1M x 1024 float32 tensor, a fit over four host partitions, a save/load
round trip — times the kernels beside their bounds and profiles one fit
(device time by kernel, the device's idle share). Each phase prints
one JSON line; the ``kernels`` line and the card's ``nvidia-smi`` name and
power limit come before the last line, which is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without CUDA, or
a directory without the package. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from spark_rapids_ml_tpu_torch import device as port_device  # noqa: E402
from spark_rapids_ml_tpu_torch.feature import PCA, PCAModel  # noqa: E402
from spark_rapids_ml_tpu_torch.ops.kernels import _build  # noqa: E402
from spark_rapids_ml_tpu_torch.ops.eigh import auto_max_iters, eigh_auto  # noqa: E402
from spark_rapids_ml_tpu_torch.ops.kernels import covariance as k1  # noqa: E402

SEED = 0
N_MAIN = 1_000_000          # rows of the main path (bench.py's width: 1M x 1024)
N_RAGGED = 1_000_003        # the kernel check's ragged row count
D = 1024
K = 16
HOST_PARTS = 4
HOST_ROWS = 65_536
REPEATS = 10

#: Every kernel of the path: (name, route, source, the TPU kernel it replaces).
KERNELS = [
    ("centered_gram", "cuda", "spark_rapids_ml_tpu_torch/csrc/centered_gram.cu",
     "spark_rapids_ml_tpu/ops/pallas/covariance.py:49"),
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
    build_s = _build.build_all(name for name, *_ in KERNELS)
    ptxas = {
        name: [ln.split("info    : ")[-1] for ln in _build.build_logs.get(name, "").splitlines()
               if "registers" in ln or "spill" in ln]
        for name, *_ in KERNELS
    }
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
    }
    emit(info)
    return info


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
        }
        results.append(row)
        require(err <= tol, f"K1 {kind} {list(x.shape)} error {err:.3e} > {tol:.0e}")
        require(plain_err <= tol, f"plain {kind} {list(x.shape)} error {plain_err:.3e} > {tol:.0e}")
        require(row["symmetric"], f"K1 {kind} {list(x.shape)} output not symmetric")
        if x is x_big:
            main_abs_err = vs_plain
        del got, plain, ref
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
    f64_bound_ms, f64_bound_by = gram_bound_ms(HOST_ROWS, d, torch.float64, peaks)
    del x64

    def fit(backend):
        m = PCA().setK(K).setCovarianceBackend(backend).fit(xm)
        return m.pc, m.explainedVariance

    out = {
        "phase": "times",
        "peaks": peaks[0],
        "k1_f32": {"shape": [n, d], "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "roofline_share": bound_ms / kernel_ms},
        "k1_f64": {"shape": [HOST_ROWS, d], "kernel_ms": f64_kernel_ms, "plain_ms": f64_plain_ms,
                   "bound_ms": f64_bound_ms, "bound_by": f64_bound_by,
                   "roofline_share": f64_bound_ms / f64_kernel_ms},
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
    x_big = planted(N_RAGGED, D, gen)
    check = phase_kernel_check(x_big, gen)
    torch.cuda.empty_cache()

    xm = x_big[:N_MAIN]
    parts = [x_big[i * HOST_ROWS:(i + 1) * HOST_ROWS].cpu().numpy() for i in range(HOST_PARTS)]
    main_path, model = phase_main_path(xm, parts)
    torch.cuda.empty_cache()
    times = phase_times(xm, model, peaks)
    phase_profile(xm)

    k1_f32 = times["k1_f32"]
    name, route, source, replaces = KERNELS[0]
    emit({"kernels": [{
        "name": name, "route": route, "source": source, "replaces": replaces,
        "launches": main_path["launches"][name],
        "max_abs_err": check["main_max_abs_err"],
        "ms": k1_f32["kernel_ms"], "kernel_ms": k1_f32["kernel_ms"],
        "plain_ms": k1_f32["plain_ms"], "bound_ms": k1_f32["bound_ms"],
        "bound_by": k1_f32["bound_by"], "library_ms": k1_f32["library_ms"],
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
