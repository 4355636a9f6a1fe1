"""Find a cell's parts by name.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
The configuration is the file that ``BENCHMARK.json`` gives it; the mix is
``traffic/<traffic>.json``; the mix's ``kind`` names its generator,
``generators/<kind>.py``; each metric is read by ``metrics/<name>.py``,
or, where a metric is split by the end-to-end metric it moves
(``idle_share.open``, ``idle_share.closed``) and has no file of its own,
by the file of its stem (``metrics/idle_share.py``).
So a configuration, a mix, a generator or a metric is added as a file,
and no file that exists has to change.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: Dict          # the configuration file's object
    mix: Dict             # the traffic mix's object
    generator: ModuleType
    metrics: List[Dict]   # BENCHMARK.json entries this cell reports
    trace: bool
    chips: int


def load_module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def reported(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a cell reports: its end-to-end metrics without tracing,
    its per-layer metrics with it. A metric with ``workloads`` is reported
    in those cells; an end-to-end metric without it in every cell, a
    per-layer one without it in every cell that reports its ``moves``."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def load_cell(name: str, trace: bool, root: Path = ROOT) -> Cell:
    bench = read_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = root / BENCH_DIR.name
    mix = read_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    gen = load_module(bench_dir / "generators" / f"{mix['kind']}.py")
    return Cell(name, read_json(root / conf["file"]), mix, gen,
                reported(bench, name, trace), trace, w["chips"])


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    """The module whose ``read(run)`` gives ``metric``: its own file, else
    the file of the name without its last ``.`` part."""
    metrics = root / BENCH_DIR.name / "metrics"
    path = metrics / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = metrics / f"{metric.rsplit('.', 1)[0]}.py"
    return load_module(path)
