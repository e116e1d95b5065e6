"""Spark integration layer (gated on pyspark) — port of the reference's
``spark/`` package.

The compute core is Spark-free (PyTorch and the port's CUDA kernels);
this subpackage is the bridge:

  - ``discovery/get_gpus_resources.sh`` — the executor GPU discovery
    script (Spark's ``getGpusResources.sh`` format, resource name
    ``"gpu"``);
  - ``resources`` — task-to-card binding (the Spark task resource
    ``"gpu"``, ``CUDA_VISIBLE_DEVICES``);
  - ``executor_math`` — numpy-only model forwards and units of work for
    executors;
  - ``barrier`` — barrier-stage gang runs and ``gang_fit``;
  - ``adapter`` — pyspark.ml estimator wrappers that run per-partition
    accumulation inside ``mapPartitions`` and reduce sufficient statistics
    through Spark, finishing on the driver's card.

pyspark is not required: importing
``spark_rapids_ml_tpu_torch.spark.adapter`` without it raises a clear
error when a class is used.
"""

from spark_rapids_ml_tpu_torch.spark.resources import (
    pin_process_to_chip,
    resolve_device_index,
    resolve_device_ordinal,
    task_gpu_address,
)

__all__ = ["pin_process_to_chip", "resolve_device_index", "resolve_device_ordinal", "task_gpu_address"]
