"""Estimator/model families of the port."""

from spark_rapids_ml_tpu_torch.models.approximate_nearest_neighbors import (
    ApproximateNearestNeighbors,
    ApproximateNearestNeighborsModel,
)
from spark_rapids_ml_tpu_torch.models.dbscan import DBSCAN, DBSCANModel
from spark_rapids_ml_tpu_torch.models.kmeans import KMeans, KMeansModel
from spark_rapids_ml_tpu_torch.models.linear_regression import LinearRegression, LinearRegressionModel
from spark_rapids_ml_tpu_torch.models.logistic_regression import LogisticRegression, LogisticRegressionModel
from spark_rapids_ml_tpu_torch.models.nearest_neighbors import NearestNeighbors, NearestNeighborsModel
from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel
from spark_rapids_ml_tpu_torch.models.random_forest import (
    RandomForestClassificationModel,
    RandomForestClassifier,
    RandomForestRegressionModel,
    RandomForestRegressor,
)
from spark_rapids_ml_tpu_torch.models.umap import UMAP, UMAPModel

__all__ = [
    "ApproximateNearestNeighbors", "ApproximateNearestNeighborsModel", "DBSCAN", "DBSCANModel",
    "KMeans", "KMeansModel", "LinearRegression", "LinearRegressionModel",
    "LogisticRegression", "LogisticRegressionModel", "NearestNeighbors", "NearestNeighborsModel",
    "PCA", "PCAModel", "RandomForestClassificationModel", "RandomForestClassifier",
    "RandomForestRegressionModel", "RandomForestRegressor", "UMAP", "UMAPModel",
]
