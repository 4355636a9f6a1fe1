"""A configuration, a traffic mix, a generator and a metric are added as
new files, and the harness finds each by its name."""
import json

from portbench.harness import loader
from portbench.tests.tiny import make_root


def add_cell(root, cell, config, traffic, metric):
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": cell, "config": config,
                           "traffic": traffic, "chips": 1, "why": "new"})
    b["per_layer"].append({"name": metric, "unit": "s", "better": "lower",
                           "source": "host_clock", "layer": "new",
                           "moves": "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def test_new_files_alone_make_a_new_cell(tmp_path):
    root = make_root(tmp_path)
    bench = root / loader.BENCH_DIR.name
    conf = json.loads((bench / "configs" / "tiny.json").read_text())
    conf["name"] = "tiny2"
    (bench / "configs" / "tiny2.json").write_text(json.dumps(conf))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="tiny2",
                             file=f"{bench.name}/configs/tiny2.json"))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (bench / "traffic" / "burst.json").write_text(json.dumps(
        {"kind": "burst", "warm_s": 0.1, "every_s": 1.0, "size": 3}))
    (bench / "generators" / "burst.py").write_text(
        "def drive(ctx, mix, fns, arch_of, seed):\n"
        "    ctx.submit(fns[0], 0.0)\n")
    (bench / "metrics" / "first_due_s.py").write_text(
        "def read(run):\n    return min(r.due for r in run.records)\n")
    add_cell(root, "tiny2.burst", "tiny2", "burst", "first_due_s")

    cell = loader.load_cell("tiny2.burst", True, root)
    assert cell.config["name"] == "tiny2"
    assert cell.mix["size"] == 3
    assert hasattr(cell.generator, "drive")
    # a per-layer metric without workloads goes to every cell that
    # reports what it moves (setup_s: every cell)
    assert "first_due_s" in [m["name"] for m in cell.metrics]

    class R:
        due = -0.5
    assert loader.reader("first_due_s", root).read(
        type("Run", (), {"records": [R()]})) == -0.5


def test_a_split_metric_reads_its_own_file_else_its_stems(tmp_path):
    root = make_root(tmp_path)
    metrics = root / loader.BENCH_DIR.name / "metrics"
    assert not (metrics / "idle_share.closed.py").exists()
    assert loader.reader("idle_share.closed", root).__file__ == str(
        metrics / "idle_share.py")
    (metrics / "idle_share.closed.py").write_text(
        "def read(run):\n    return 1.0\n")
    assert loader.reader("idle_share.closed", root).read(None) == 1.0


def test_reported_metrics_follow_workloads_and_moves():
    bench = loader.read_json(loader.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        e2e = {m["name"] for m in loader.reported(bench, w["name"], False)}
        per = loader.reported(bench, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert per, w["name"]
        assert all(m["moves"] in e2e for m in per)


def test_every_metric_and_mix_has_its_file():
    bench = loader.read_json(loader.ROOT / "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(loader.reader(m["name"]), "read"), m["name"]
    for w in bench["workloads"]:
        cell = loader.load_cell(w["name"], False)
        assert cell.config["name"] == w["config"]
