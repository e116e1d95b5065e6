"""One Lloyd pass's counted work over n rows, k centres and d features:
2·n·k·d operations (the score products, two per multiply-add); float32
rows and centres read once, the sums, counts, cost and centre norms
written once (``cost`` of ``spark_rapids_ml_tpu_torch/ops/kernels/kmeans.py``
and ``ops/kmeans.lloyd_iteration_cost``, frozen here)."""


def work(n: int, d: int, k: int) -> dict:
    return {"flops": 2.0 * n * k * d, "bytes": float(4 * (n * d + k * d) + 4 * k * d + 8 * k + 4 + 4 * k)}
