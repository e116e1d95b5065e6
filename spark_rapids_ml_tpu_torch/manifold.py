"""Manifold-learning namespace — the UMAP estimator (the reference's
``spark_rapids_ml_tpu.manifold``)."""

from spark_rapids_ml_tpu_torch.models.umap import UMAP, UMAPModel

__all__ = ["UMAP", "UMAPModel"]
