"""Classification namespace — parity with ``org.apache.spark.ml.classification``
and the reference's ``spark_rapids_ml_tpu.classification``."""

from spark_rapids_ml_tpu_torch.models.logistic_regression import LogisticRegression, LogisticRegressionModel
from spark_rapids_ml_tpu_torch.models.random_forest import RandomForestClassificationModel, RandomForestClassifier

__all__ = [
    "LogisticRegression", "LogisticRegressionModel",
    "RandomForestClassificationModel", "RandomForestClassifier",
]
