"""What ``BENCHMARK.json`` names, found by name: a cell, its configuration file, its
traffic mix (``traffic/<traffic>.json``), its limits (``limits/<cell>.json``), the
driver the traffic names (``drivers/<driver>.py``) and the reader of each per-layer
metric (``metrics/<metric>.py``).  A new cell, configuration, traffic mix or metric is
new files and new entries; nothing here changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict            # the workload entry
    config: dict           # the configuration file
    traffic: dict          # the traffic file
    limits: dict           # {number: limit}
    end_to_end: list       # the end-to-end metric entries this cell reports
    per_layer: list        # the per-layer metric entries this cell reports


def reports(metric: dict, cell: str, end_to_end: list[dict]) -> bool:
    """Whether ``cell`` reports ``metric``: the metric's ``workloads`` list it, or, for a
    metric without one, the cell reports the end-to-end metric it moves (an end-to-end
    metric without one is reported everywhere)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" not in metric:
        return True
    moved = [m for m in end_to_end if m["name"] == metric["moves"]]
    return bool(moved) and reports(moved[0], cell, end_to_end)


def cell(name: str, bench: dict, base: Path = HERE) -> Cell:
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = work[name]
    confs = {c["name"]: c for c in bench["configs"]}
    conf = load_json(base.parent / confs[entry["config"]]["file"])
    traffic = load_json(base / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(base / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name, bench["end_to_end"])]
    pl = [m for m in bench["per_layer"] if reports(m, name, bench["end_to_end"])]
    return Cell(name, entry, conf, traffic, limits, e2e, pl)


def driver(traffic: dict):
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def reader(metric: str, base: Path = HERE):
    """``read(record) -> number | None`` of ``metrics/<metric>.py``."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolved(conf: dict, overrides: dict | None = None) -> dict:
    """The configuration file's ``config`` dict (the whole configuration as it is run)
    with ``overrides`` ({"section.key": value}, such as a traffic mix's) applied."""
    d = json.loads(json.dumps(conf["config"]))
    for path, value in (overrides or {}).items():
        *parents, last = path.split(".")
        node = d
        for p in parents:
            node = node[p]
        if last not in node:
            raise KeyError(f"override {path!r}: no such key")
        node[last] = value
    return d


def port_config(d: dict):
    """The port's ``Config`` built from a resolved configuration dict."""
    from lshm_tpu_torch import config as C

    def build(cls, values: dict):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in values:
                continue
            v = values[f.name]
            if f.name == "lbfgs":
                v = build(C.LBFGSConfig, v)
            elif f.name == "ramp":
                v = tuple(build(C.RampStage, r) for r in v)
            elif isinstance(v, list):
                v = tuple(v)
            kw[f.name] = v
        return cls(**kw)

    return C.Config(data=build(C.DataConfig, d["data"]), model=build(C.ModelConfig, d["model"]),
                    loss=build(C.LossConfig, d["loss"]), optim=build(C.OptimConfig, d["optim"]),
                    train=build(C.TrainConfig, d["train"]))
