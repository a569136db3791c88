"""``BENCHMARK.json`` and the data files it names: every file loads, every
name and unit keeps to the allowed characters, every metric has what reads
it, and every cell reports what the contract asks."""

import json
import re

import pytest

from port_bench.spec import BENCH_DIR, ROOT, load_benchmark, load_cell, load_module, reader_path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: the end-to-end metrics ``run.py`` computes
END_TO_END = {"member_steps_per_s", "setup_s"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}

BENCH = load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names)), kind
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_and_names_only_known_metrics(cell):
    c = load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert {name.split(".")[0] for name in e2e} <= END_TO_END
    assert c.per_layer
    moves = {m["moves"] for m in c.per_layer}
    assert moves <= e2e
    for m in c.per_layer:
        assert callable(load_module(reader_path(m["name"])).read)
    for name in ("energy_gap", "q_gap", "p_gap"):
        assert c.limits[name] > 0
    if c.drift_every:
        assert {"drift_max", "sampler_gap", "sampler_excess"} <= set(c.limits)
    integ = c.config["integrator"]
    assert c.steps % integ["chunk_steps"] == 0
    assert integ["chunk_steps"] % integ["steps_per_call"] == 0
    assert c.drift_every is None or integ["chunk_steps"] % c.drift_every == 0


def test_every_config_is_used_and_layers_are_consistent():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    readers = {p.stem for p in (BENCH_DIR / "metrics").glob("*.py")}
    assert {reader_path(m["name"]).stem for m in BENCH["per_layer"]} <= readers
    for stem in readers:
        assert callable(load_module(BENCH_DIR / "metrics" / f"{stem}.py").read)
