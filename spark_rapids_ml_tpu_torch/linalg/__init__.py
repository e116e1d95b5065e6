"""Row-matrix orchestration of the port (the reference's ``linalg``)."""

from spark_rapids_ml_tpu_torch.linalg.row_matrix import RowMatrix

__all__ = ["RowMatrix"]
