"""The counted work of one fit of ``configs/kmeans_20m_d16_k100.json``:
seeding's distances (``counts/seeding.py``) and one Lloyd pass
(``counts/lloyd.py``) per iteration and one for the final cost, by the
fits' mean ``numIter``."""


def fit_flops(ctx) -> float:
    k = int(ctx.config["estimator"]["params"]["k"])
    passes = sum(int(a["iters"]) + 1 for a in ctx.answers) / len(ctx.answers)
    return (ctx.count("seeding").work(ctx.rows, ctx.cols, k)["flops"]
            + passes * ctx.count("lloyd").work(ctx.rows, ctx.cols, k)["flops"])
