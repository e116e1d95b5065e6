"""The covariance layer's counted work for an (n, d) input: the column
mean's n·d adds, and the centred Gram's n·d·(d+1) operations (the
symmetric half, two per multiply-add: ``cost`` of
``spark_rapids_ml_tpu_torch/ops/kernels/covariance.py`` and the bound of
``chip_smoke.gram_bound_ms``, frozen here); the input read once and the
(d, d) Gram written once."""


def work(n: int, d: int, itemsize: int = 4) -> dict:
    return {"flops": float(n * d + n * d * (d + 1)), "bytes": float((n * d + d * d) * itemsize)}
