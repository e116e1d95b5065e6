"""Estimator/model families of the port."""

from spark_rapids_ml_tpu_torch.models.kmeans import KMeans, KMeansModel
from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel
from spark_rapids_ml_tpu_torch.models.umap import UMAP, UMAPModel

__all__ = ["KMeans", "KMeansModel", "PCA", "PCAModel", "UMAP", "UMAPModel"]
