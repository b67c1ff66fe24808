"""``BENCHMARK.json`` against the benchmark's contract: names, units,
keys, bounds, the run length's budget, and that every file it names is
there, found by name."""
from __future__ import annotations

import json
import re

import pytest
from bench_testing import BENCH, ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head_size|expansion|per_tok|channels)")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_command():
    assert set(MANIFEST) == TOP
    assert MANIFEST["command"] == ["python3", "bench/run.py"]
    assert MANIFEST["paths"] == ["bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_run_fits_the_check():
    """A full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s,
    2 x 90 s a cell to compile, 1200 s spare, within 43200 s."""
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_plain(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_configs():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (BENCH / "configs" / f"{c['name']}.py").is_file()
        assert (BENCH / "reference" / f"{cfg['reference']}.py").is_file()
        assert cfg["limits"], "a configuration states its comparison limits"
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


def test_workloads():
    pairs = set()
    four = 0
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [w["name"] for w in
                                            MANIFEST["workloads"]])


def test_every_cell_reports_what_its_metrics_move():
    """Each per-layer metric's ``moves`` is reported by every cell that
    lists it; each cell reports setup_s, one more end-to-end metric and a
    per-layer one."""
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for w in MANIFEST["workloads"]:
        mine = [m["name"] for m in MANIFEST["end_to_end"]
                if _reports(m, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in MANIFEST["per_layer"]
                 if _reports(m, w["name"])]
        assert layer
        for m in layer:
            assert _reports(e2e[m["moves"]], w["name"])


def test_layers_are_named_alike():
    """Metrics of one layer give the same ``layer``, letter for letter."""
    by_layer: dict[str, set] = {}
    for m in MANIFEST["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_paths_hold_only_the_benchmark():
    for p in MANIFEST["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for f in (ROOT / "bench").rglob("*"):
        if f.is_file() and ".cache" not in f.parts \
                and "__pycache__" not in f.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$",
                            str(f.relative_to(ROOT))), f
