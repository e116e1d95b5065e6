"""Regression namespace — parity with ``org.apache.spark.ml.regression``
and the reference's ``spark_rapids_ml_tpu.regression``."""

from spark_rapids_ml_tpu_torch.models.linear_regression import LinearRegression, LinearRegressionModel
from spark_rapids_ml_tpu_torch.models.random_forest import RandomForestRegressionModel, RandomForestRegressor

__all__ = ["LinearRegression", "LinearRegressionModel", "RandomForestRegressionModel", "RandomForestRegressor"]
