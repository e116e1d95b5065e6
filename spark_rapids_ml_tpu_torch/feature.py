"""User-facing feature namespace — parity with ``com.nvidia.spark.ml.feature``
and the reference's ``spark_rapids_ml_tpu.feature``."""

from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel

__all__ = ["PCA", "PCAModel"]
