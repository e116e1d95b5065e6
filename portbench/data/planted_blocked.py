"""PCA rows with a planted spectrum, made on the device in row blocks.

x = z·diag(s)·Qᵀ + μ with z standard normal, Q a random orthogonal
matrix, s_i = 1 + lift·decay^i for the top ``top`` directions and 1 for
the rest (unit noise), μ ~ N(0, offset²) per column. This is the
spectrum of the port's on-card smoke (``planted`` in ``chip_smoke.py``),
frozen here; the smoke builds z and x whole, which at an executor's share
of rows would need twice the card, so this copy fills x block by block in
place. The same seed gives the same rows on the same device.
"""

from __future__ import annotations

import torch


def make(shape: dict, params: dict, seed: int, device: torch.device) -> torch.Tensor:
    n, d = int(shape["rows"]), int(shape["cols"])
    top, block = int(params["top"]), int(params["block_rows"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=gen, device=device, dtype=torch.float64))
    s = torch.ones(d, dtype=torch.float64, device=device)
    s[:top] += params["lift"] * params["decay"] ** torch.arange(top, dtype=torch.float64, device=device)
    mu = params["offset"] * torch.randn(d, generator=gen, device=device, dtype=torch.float64)
    qt, sf, muf = q.T.float().contiguous(), s.float(), mu.float()
    x = torch.empty((n, d), dtype=torch.float32, device=device)
    for r0 in range(0, n, block):
        rows = min(block, n - r0)
        z = torch.randn((rows, d), generator=gen, device=device, dtype=torch.float32)
        z.mul_(sf)
        torch.matmul(z, qt, out=x[r0:r0 + rows])
        x[r0:r0 + rows].add_(muf)
        del z
    return x
