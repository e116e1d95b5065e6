"""Find a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell, its
configuration and its traffic mix; every part lives in a file of its own
under the benchmark's folder, found by that name:

- ``configs/<config>.json``: the configuration (estimator, shapes, data
  parameters, the comparison's limits);
- ``traffic/<traffic>.json``: the traffic mix, parameters that the loop
  it names reads;
- ``loops/<loop>.py``: the loop that drives a kind of traffic (see
  ``lib/window.py``), with the number of cards it drives;
- ``data/<generator>.py``: the data generator the configuration names;
- ``reference/<family>.py``: the plain reference the configuration names;
- ``layers/<metric>.py``: the reader of one per-layer metric;
- ``counts/<count>.py``: the counted work of one operation.

Adding a cell, a configuration, a traffic mix, a kind of loop or a metric
adds files and entries; no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class SpecError(ValueError):
    """A cell, configuration, traffic mix or part that cannot be found."""


def load_json(path: Path) -> dict:
    try:
        with open(path) as fh:
            return json.load(fh)
    except FileNotFoundError:
        raise SpecError(f"missing file: {path}") from None


def load_module(path: Path, prefix: str) -> ModuleType:
    """Import the Python file ``path`` as a module of its own (names may
    hold dots, as ``idle_share.fit`` does, so no package import)."""
    if not path.is_file():
        raise SpecError(f"missing file: {path}")
    name = f"portbench_{prefix}_{path.stem.replace('.', '_').replace('-', '_')}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its parts resolved."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def generator(self) -> ModuleType:
        return load_module(self.bench_dir / "data" / f"{self.config['generator']}.py", "data")

    def reference(self) -> ModuleType:
        return load_module(self.bench_dir / "reference" / f"{self.config['family']}.py", "reference")

    def loop(self) -> ModuleType:
        return load_module(self.bench_dir / "loops" / f"{self.traffic['loop']}.py", "loops")


def count(bench_dir: Path, name: str) -> ModuleType:
    """The counted work ``counts/<name>.py``."""
    return load_module(bench_dir / "counts" / f"{name}.py", "counts")


def _reports(metric: dict, cell: str, e2e_names: Optional[List[str]]) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, else every
    cell (an end-to-end metric) or every cell that reports the end-to-end
    metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, bench_dir: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (at the root above
    ``bench_dir``), with its configuration, traffic mix and the metrics it
    reports; :class:`SpecError` for an unknown name, a missing part, or a
    loop that drives another number of cards than the cell asks for (a
    cell of four cards needs a loop that starts and reports four ranks)."""
    bench_dir = Path(bench_dir) if bench_dir is not None else BENCH_DIR
    bench = load_json(bench_dir.parent / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SpecError(f"unknown workload {name!r}; known: {', '.join(sorted(entries))}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if entry["config"] not in configs:
        raise SpecError(f"workload {name!r} names unknown config {entry['config']!r}")
    config = load_json(bench_dir.parent / configs[entry["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, None)]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    cell = Cell(name, entry, config, traffic, e2e, per_layer, bench_dir)
    drives = int(getattr(cell.loop(), "CHIPS", 0))
    if drives != cell.chips:
        raise SpecError(f"workload {name!r} asks for {cell.chips} card(s); its loop "
                        f"{traffic['loop']!r} drives {drives}")
    return cell
