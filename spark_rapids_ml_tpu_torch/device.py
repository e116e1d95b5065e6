"""Where the port's entry points compute.

The counterpart of ``jax.config.update("jax_platforms", ...)``: one
process-wide platform, ``"cuda"`` by default. ``set_platform("cpu")``
sends host inputs to the CPU instead (the tests do this). A
``torch.Tensor`` input always computes where it lives, as a ``jax.Array``
does in the reference (``core/data.py::is_device_array``); the platform
only decides where HOST inputs (numpy partitions, DataFrames) go.

On ``"cuda"`` there is no quiet fallback: without a usable card,
:func:`resolve_device` raises.
"""

from __future__ import annotations

import torch

PLATFORMS = ("cuda", "cpu")

_platform = "cuda"


def set_platform(name: str) -> None:
    """Select the platform host inputs compute on: ``"cuda"`` or ``"cpu"``."""
    global _platform
    if name not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, got {name!r}")
    _platform = name


def get_platform() -> str:
    return _platform


def use_ieee_fp32_matmul() -> None:
    """Turn TF32 off for float32 matrix products on the card. TF32 keeps
    about three decimal digits; the ``highest`` precision mode promises
    IEEE fp32 products (the reference's ``Precision.HIGHEST``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("could not turn TF32 off for float32 matmul")


def resolve_device(gpu_id: int = -1) -> torch.device:
    """The device host inputs compute on — the twin of the reference's
    ``RowMatrix._device`` (``gpuId=-1`` is the first card, ``gpuId=i``
    the i-th). Raises ``RuntimeError`` on ``"cuda"`` without a card."""
    if _platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the platform is 'cuda' but torch.cuda.is_available() is False; "
            "call spark_rapids_ml_tpu_torch.device.set_platform('cpu') to "
            "compute on the CPU"
        )
    count = torch.cuda.device_count()
    index = 0 if gpu_id < 0 else int(gpu_id)
    if index >= count:
        raise ValueError(f"gpuId={gpu_id} but only {count} CUDA device(s) are visible")
    use_ieee_fp32_matmul()
    return torch.device("cuda", index)


def device_of(x: torch.Tensor) -> torch.device:
    """Where a tensor input computes: where it lives. A CUDA tensor also
    gets the fp32 matmul setting the ``highest`` mode relies on."""
    if x.device.type == "cuda":
        use_ieee_fp32_matmul()
    return x.device
