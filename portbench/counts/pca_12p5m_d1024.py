"""The counted work of one fit of ``configs/pca_12p5m_d1024.json``: the
covariance layer's (``counts/covariance.py``). The eigensolve of the
(1024, 1024) covariance is left out: under 1e-3 of it."""


def fit_flops(ctx) -> float:
    return ctx.count("covariance").work(ctx.rows, ctx.cols)["flops"]
