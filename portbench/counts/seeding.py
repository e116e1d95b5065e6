"""Greedy k-means++ seeding's counted distance work over n rows of d
features for k centres: the first centre's distances (2·n·d), then for
each further centre the distances of its ``2 + ceil(log2 k)`` candidates
(2·n·d each); the rows read once per centre."""

import math


def work(n: int, d: int, k: int) -> dict:
    t = min(2 + max(int(math.ceil(math.log2(k))), 0), n)
    return {"flops": 2.0 * n * d * (1 + (k - 1) * t), "bytes": float(4 * n * d * k)}
