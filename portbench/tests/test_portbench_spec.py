"""``BENCHMARK.json`` against the benchmark's contract, every entry resolved to its
files, and a new cell added as files and entries alone."""

import dataclasses
import json
import re
import shutil

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    cells = len(BENCH["workloads"])
    # a full check: 2 + 14 runs a cell, each run_seconds + 60, 180 s a cell to compile,
    # 1200 s spare, within 43200 s for 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert cells >= 1


def test_entries():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs and 1 <= len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        # the metric it moves is reported in every cell that reports it
        for cell in m["workloads"]:
            assert spec.reports(e2e[m["moves"]], cell, BENCH["end_to_end"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = spec.cell(cell, BENCH)
    assert spec.driver(c.traffic).run
    assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert all(v is not None for v in c.limits.values()) and c.limits


@pytest.mark.parametrize("path", sorted((spec.HERE / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_config_file_is_the_preset_with_its_overrides(path):
    from lshm_tpu_torch.config import preset

    f = spec.load_json(path)
    for conf in BENCH["configs"]:
        if conf["file"] == f"portbench/configs/{path.name}":
            assert f["reduced"] == conf["reduced"] and f["source"] == conf["source"]
    want = dataclasses.asdict(preset(f["preset"]))
    for path, value in f["overrides"].items():
        sec, key = path.split(".")
        want[sec][key] = value
    assert json.loads(json.dumps(want)) == f["config"]
    assert spec.port_config(spec.resolved(f)) == preset(f["preset"]).replace(
        train=dataclasses.replace(preset(f["preset"]).train, checkpoint_dir=""))


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric, each a new file,
    with new entries in a copy of BENCHMARK.json: resolved with no edit elsewhere."""
    base = tmp_path / "portbench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    conf = spec.load_json(base / "configs" / "full_khm.json")
    conf["name"] = "dummy"
    (base / "configs" / "dummy.json").write_text(json.dumps(conf))
    (base / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"driver": "trainer", "rate_metric": "train_patches_per_s", "stations": 9,
         "check_steps": 3, "profile_units": 1, "overrides": {}}))
    (base / "limits" / "dummy.dummy_mix.json").write_text(json.dumps({"loss_gap": 1.0}))
    (base / "metrics" / "dummy_metric.py").write_text("def read(rec):\n    return 42.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "dummy", "source": "x", "file": "portbench/configs/dummy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dummy_metric", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "data",
                               "moves": "train_patches_per_s",
                               "workloads": ["dummy.dummy_mix"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_patches_per_s":
            m["workloads"].append("dummy.dummy_mix")
    c = spec.cell("dummy.dummy_mix", bench, base=base)
    assert c.config["name"] == "dummy" and c.limits == {"loss_gap": 1.0}
    assert [m["name"] for m in c.per_layer] == ["dummy_metric"]
    assert spec.reader("dummy_metric", base=base)({}) == 42.0
    assert {m["name"] for m in c.end_to_end} == {"train_patches_per_s", "setup_s"}
