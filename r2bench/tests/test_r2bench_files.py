"""Every workload, configuration, traffic and metric file loads by name, and
``BENCHMARK.json`` keeps the benchmark's contract."""

import json
import re

import pytest

from r2bench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "r2bench/run.py"] and BENCH["paths"] == ["r2bench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [e["why"] for k in ("configs", "workloads") for e in BENCH[k]]
    texts += [m["layer"] for m in BENCH["per_layer"]] + [c["source"] for c in BENCH["configs"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        have = [n for n, m in e2e.items() if cell in m.get("workloads", CELLS)]
        assert "setup_s" in have and len(have) >= 2


def test_per_layer_metrics_have_readers_and_move_a_cells_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
        assert harness.load_reader(m["name"])({}) is None
        for cell in m["workloads"]:
            assert cell in CELLS and cell in e2e[m["moves"]].get("workloads", CELLS)
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
    for cell in CELLS:
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    c = harness.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.chips == entry["chips"] == 1
    assert (harness.BENCH / "drivers" / f"{c.driver}.py").exists()
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert 0 < len(entry["why"]) <= 200


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert cfg["file"] == f"r2bench/configs/{cfg['name']}.json"
    c = harness.load("configs", cfg["name"])
    assert sorted(c["reduced"]) == sorted(cfg["reduced"])
    assert c["head_dim"] * c["num_attention_heads"] == c["hidden_size"]
    assert c["precision"]["weights"] == "float32" and c["precision"]["tf32"] is False
    widths = {"hidden_size", "intermediate_size", "head_dim", "num_attention_heads",
              "num_key_value_heads"}
    assert not widths & set(cfg["reduced"])
    from r2bench.drivers.common import port_config
    assert port_config(c).num_layers == c["num_hidden_layers"]


def test_every_config_and_traffic_is_used():
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert (harness.BENCH / "traffic" / f"{w['traffic']}.json").exists()
