"""Executor-side GPU resource binding — port of the reference's
``spark/resources.py``.

Spark binds each task to a GPU through the task resource ``"gpu"``
(``TaskContext.get().resources()["gpu"].addresses[0]``), the resource
that Spark's ``getGpusResources.sh`` discovery script publishes. This
module resolves which card THIS process uses, from (in priority order)
an explicit ordinal (the ``gpuId`` param), the Spark task resource, or
card 0, and pins the process to it.

Pinning sets ``CUDA_VISIBLE_DEVICES`` to the one ordinal, which the CUDA
runtime reads when it initializes in the process: a process that has
already initialized CUDA sees every card and cannot be pinned, so
:func:`pin_process_to_chip` raises there instead of going on.
"""

from __future__ import annotations

import os
from typing import Optional

#: The Spark resource name of an NVIDIA card.
RESOURCE_NAME = "gpu"


def task_gpu_address() -> Optional[str]:
    """The card address assigned to the current Spark task, when running
    under pyspark with ``gpu`` task resources; None otherwise."""
    try:
        from pyspark import TaskContext  # type: ignore
    except ImportError:
        return None
    ctx = TaskContext.get()
    if ctx is None:
        return None
    resources = ctx.resources()
    if RESOURCE_NAME not in resources:
        return None
    return resources[RESOURCE_NAME].addresses[0]


def resolve_device_ordinal(explicit: int = -1) -> int:
    """The card ordinal for this process.

    Priority: the explicit param (``gpuId`` semantics) > the Spark task
    resource > 0 (the driver's default card)."""
    if explicit >= 0:
        return explicit
    addr = task_gpu_address()
    if addr is not None:
        return int(addr)
    return 0


def visible_index(ordinal: int) -> int:
    """The index this process's CUDA runtime gives card ``ordinal``: its
    position in ``CUDA_VISIBLE_DEVICES`` when the variable lists it
    (``cuda:0`` once :func:`pin_process_to_chip` ran, or where a cluster
    manager isolates the task's cards), else the ordinal itself."""
    listed = [a.strip() for a in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")]
    return listed.index(str(ordinal)) if str(ordinal) in listed else ordinal


def resolve_device_index(explicit: int = -1) -> int:
    """The torch device index of this process's card. An explicit
    ``gpuId`` is already an index into the visible cards; the Spark task
    resource names a host card, which :func:`visible_index` maps to the
    index this process sees it at; 0 otherwise."""
    if explicit >= 0:
        return explicit
    addr = task_gpu_address()
    if addr is not None:
        return visible_index(int(addr))
    return 0


def pin_process_to_chip(ordinal: int) -> None:
    """Restrict this process's CUDA view to card ``ordinal``.

    Must run before CUDA initializes in the process. The assignment is
    unconditional: an executor often inherits ``CUDA_VISIBLE_DEVICES``
    listing every card of the host (the value the discovery script
    enumerates), and keeping it would let this process claim them all.
    Raises ``RuntimeError`` when CUDA is already initialized, since the
    pin could no longer take effect."""
    import torch

    if torch.cuda.is_initialized():
        raise RuntimeError(
            f"cannot pin this process to card {ordinal}: CUDA is already "
            "initialized here and sees every visible card; call "
            "pin_process_to_chip before the first CUDA call"
        )
    os.environ["CUDA_VISIBLE_DEVICES"] = str(ordinal)
