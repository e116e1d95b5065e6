"""The counted work of one fit of ``configs/pca_50m_d1024_gang4.json``, per
card: one rank's covariance work (``counts/covariance.py`` over its
``rows``), which every rank does at once. The moments merge (8 MB a
rank) and the eigensolve of the (1024, 1024) covariance are left out:
under 1e-3 of it."""


def fit_flops(ctx) -> float:
    return ctx.count("covariance").work(ctx.rows, ctx.cols)["flops"]
