"""Published peaks of the cards the benchmark may run on (NVIDIA's data
sheets, dense rates without sparsity, at the full power limit): float32
outside the tensor cores and HBM bandwidth. A roofline share or an MFU is
taken against these; a card not in the table gets none (the readers
report nothing rather than a share of a guessed peak)."""

from __future__ import annotations

from typing import Optional

#: (name fragment, fp32 FLOP/s, HBM bytes/s); the first fragment found in
#: ``torch.cuda.get_device_name()`` wins.
TABLE = (
    ("H100 80GB HBM3", 67e12, 3.35e12),   # the H100 SXM part's name on the card
    ("H100 SXM", 67e12, 3.35e12),
)


def for_device(name: str) -> Optional[dict]:
    for fragment, fp32, hbm in TABLE:
        if fragment in name:
            return {"fp32_flops": fp32, "hbm_bytes": hbm}
    return None


def least_seconds(work: dict, peaks: dict) -> float:
    """The least time for ``work`` (``flops``, ``bytes``): the larger of
    its operations at the float32 peak and its bytes at HBM's."""
    return max(work["flops"] / peaks["fp32_flops"], work["bytes"] / peaks["hbm_bytes"])
