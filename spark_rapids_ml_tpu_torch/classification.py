"""Classification namespace — parity with ``org.apache.spark.ml.classification``
and the reference's ``spark_rapids_ml_tpu.classification`` (the random
forest classifier arrives with its slice, ROADMAP A.6 item 15)."""

from spark_rapids_ml_tpu_torch.models.logistic_regression import LogisticRegression, LogisticRegressionModel

__all__ = ["LogisticRegression", "LogisticRegressionModel"]
