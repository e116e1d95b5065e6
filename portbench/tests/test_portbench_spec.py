"""The benchmark's definition: every cell's parts are found by name, an
unknown name is refused, and ``BENCHMARK.json`` keeps to the contract's
shapes and characters."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench.lib import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.match(w["traffic"]) and w["config"] in names
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert len(m["layer"]) <= 200
    every = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(NAME.match(e["name"]) for e in every)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in BENCH["end_to_end"] + BENCH["per_layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_parts_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == cell.entry["config"]
    loop = cell.loop()
    assert loop.CHIPS == cell.chips and callable(loop.run) and callable(loop.context)
    assert callable(cell.generator().make)
    ref = cell.reference()
    for fn in ("fit", "read_fit", "as_answer", "judge_fit"):
        assert callable(getattr(ref, fn))
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.load_module(cell.bench_dir / "layers" / f"{m['name']}.py", "layers").read)
    for m in cell.end_to_end:
        assert callable(spec.load_module(cell.bench_dir / "end_to_end" / f"{m['name']}.py", "end_to_end").read)
    assert set(cell.config["limits"]) >= {"pc_max_abs"} or set(cell.config["limits"]) >= {"cost_rel"}


def test_unknown_cell_is_refused():
    with pytest.raises(spec.SpecError, match="unknown workload"):
        spec.load_cell("pca.nothing")


def test_a_cell_whose_loop_drives_another_number_of_cards_is_refused(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads(json.dumps(BENCH))
    doc["workloads"].append(dict(doc["workloads"][0], name="pca.fit.four", chips=4))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    with pytest.raises(spec.SpecError, match="asks for 4 card"):
        spec.load_cell("pca.fit.four", bench)
    assert spec.load_cell(doc["workloads"][0]["name"], bench).chips == 1


def test_four_chip_cells_are_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS)
