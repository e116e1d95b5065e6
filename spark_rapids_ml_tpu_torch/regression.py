"""Regression namespace — parity with ``org.apache.spark.ml.regression``
and the reference's ``spark_rapids_ml_tpu.regression`` (the random forest
regressor arrives with its slice, ROADMAP A.6 item 15)."""

from spark_rapids_ml_tpu_torch.models.linear_regression import LinearRegression, LinearRegressionModel

__all__ = ["LinearRegression", "LinearRegressionModel"]
