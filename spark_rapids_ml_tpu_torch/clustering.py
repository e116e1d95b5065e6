"""Clustering namespace — parity with ``org.apache.spark.ml.clustering``
and the reference's ``spark_rapids_ml_tpu.clustering``."""

from spark_rapids_ml_tpu_torch.models.dbscan import DBSCAN, DBSCANModel
from spark_rapids_ml_tpu_torch.models.kmeans import KMeans, KMeansModel

__all__ = ["DBSCAN", "DBSCANModel", "KMeans", "KMeansModel"]
