"""A cell at a tiny size on the CPU, through the port's plain paths: the
harness's whole run (set-up, window, traced slice, reference and
comparison) without the look for a card. It returns the outcome and
prints nothing; a CPU run gives no device metric."""

import time
from pathlib import Path
from typing import Optional

import torch

from portbench.lib import cell as cell_run
from portbench.lib import spec

#: Tiny shapes per configuration family: rows, columns.
TINY = {"pca": (20000, 256), "kmeans": (20000, 16)}


def tiny_cell(name: str, bench_dir: Optional[Path] = None) -> spec.Cell:
    cell = spec.load_cell(name, bench_dir)
    rows, cols = TINY[cell.config["family"]]
    cell.config.update(rows=rows, cols=cols)
    if "block_rows" in cell.config["data"]:
        cell.config["data"]["block_rows"] = 4000
    return cell


def rehearse(name: str, trace: bool = False, seconds: float = 0.4, seed: int = 2**31 + 77,
             bench_dir: Optional[Path] = None):
    cell = tiny_cell(name, bench_dir)
    return cell_run.execute(cell, seed, seconds, trace, [torch.device("cpu")], [("start", time.perf_counter())],
                            log=lambda *a: None)
