"""KMeans rows around planted blob centres, made on the device.

``k`` blob centres ~ N(0, scale²) per feature, each row one centre chosen
uniformly plus unit normal noise: the blobs of the port's on-card smoke
(``planted_blobs`` in ``chip_smoke.py``), frozen here. At scale 50 over 16
features no row lies near a Voronoi boundary between blob means. The
same seed gives the same rows on the same device.
"""

from __future__ import annotations

import torch


def make(shape: dict, params: dict, seed: int, device: torch.device) -> torch.Tensor:
    n, d, k = int(shape["rows"]), int(shape["cols"]), int(params["blobs"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    truth = params["scale"] * torch.randn((k, d), generator=gen, device=device)
    x = torch.empty((n, d), dtype=torch.float32, device=device)
    x.normal_(generator=gen)
    x += truth[torch.randint(0, k, (n,), generator=gen, device=device)]
    return x
