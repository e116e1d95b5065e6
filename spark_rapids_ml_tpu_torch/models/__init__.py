"""Estimator/model families of the port."""

from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel

__all__ = ["PCA", "PCAModel"]
