"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import os
import re

from checkout import BENCH, REPO, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return load(os.path.join(REPO, "BENCHMARK.json"))


def line_ok(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(line_ok(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"]) and line_ok(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line_ok(w["why"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert line_ok(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for group in ("configs", "workloads"):
        names = [x["name"] for x in b[group]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])


def test_every_cell_reports_what_the_contract_asks():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
    for cell in cells:
        reported = [n for n, ws in e2e.items() if cell in ws]
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert any(cell in m["workloads"] for m in b["per_layer"]), cell
        assert any(cell in m["workloads"] and "mfu" in m["name"] for m in b["per_layer"]), cell
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}


def test_files_are_found_by_name_and_agree():
    b = bench()
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/")
        cfg = load(os.path.join(REPO, c["file"]))
        assert cfg["name"] == c["name"]
    configs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        spec = load(os.path.join(BENCH, "workloads", f"{w['name']}.json"))
        assert (spec["config"], spec["traffic"], spec["chips"]) == (w["config"], w["traffic"], w["chips"])
        assert spec["config"] in configs
        assert os.path.isfile(os.path.join(BENCH, "drivers", f"{spec['driver']}.py"))
        assert spec["check"]["limits"]
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py")), m["name"]


def test_the_check_fits_the_budget_with_24_cells():
    rs = bench()["run_seconds"]
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_command_names_only_files_under_paths():
    b = bench()
    for word in b["command"][1:]:
        assert not word.startswith("/") and ".." not in word.split("/")
        if os.path.exists(os.path.join(REPO, word)):
            assert any(word == p or word.startswith(p + "/") for p in b["paths"])
    with open(os.path.join(REPO, ".gitignore")) as fh:
        ignored = fh.read()
    assert "benchmark/.cache/" in ignored
