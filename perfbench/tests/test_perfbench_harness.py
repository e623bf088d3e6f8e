"""The harness on the CPU: every name of BENCHMARK.json found by files
alone, the copied FLOP walks equal to the port's, and no module of the
benchmark that reaches JAX or the JAX package."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import perfbench.entries
import perfbench.kinds
from perfbench import drive, run, walks

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "uavdet_tpu"}


def test_every_name_is_found_by_its_files():
    bench = run.load_benchmark()
    for cell in bench["workloads"]:
        _, conf, config, mix = run.cell_entries(bench, cell["name"])
        assert config["name"] == conf["name"] == cell["config"]
        assert callable(drive.cell_class(mix["kind"]))
        assert callable(drive.entry(config["entry"]).build)
        assert (BENCH / "limits" / f"{cell['name']}.json").is_file()
        assert (BENCH / "reference" / f"{config['reference']}.py").is_file()
        assert (BENCH / "walks" / f"{config['walk']}.py").is_file()
    for m in bench["end_to_end"]:
        assert callable(run.reader(m["name"]))
    for m in bench["per_layer"]:
        assert callable(run.reader(m["name"]))
        moves = {e["name"]: e for e in bench["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(moves.get("workloads", m[
            "workloads"]))


def test_a_new_cell_config_mix_and_metric_need_files_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((BENCH / "configs" / "dyyolo.json").read_text())
    config["name"] = "dyyolo_copy"
    (tmp_path / "perfbench/configs/dyyolo_copy.json").write_text(
        json.dumps(config))
    mix = json.loads((BENCH / "traffic" / "serve_b16.json").read_text())
    (tmp_path / "perfbench/traffic/serve_b4.json").write_text(
        json.dumps(dict(mix, batch=4)))
    (tmp_path / "perfbench/metrics/frames_seen.py").write_text(
        "def read(ctx):\n    return ctx['window']['attempted']\n")
    bench["configs"].append(dict(bench["configs"][0], name="dyyolo_copy",
                                 file="perfbench/configs/dyyolo_copy.json"))
    bench["workloads"].append(dict(bench["workloads"][0],
                                   name="dyyolo_copy_serve_b4",
                                   config="dyyolo_copy", traffic="serve_b4"))
    bench["per_layer"].append(dict(bench["per_layer"][0], name="frames_seen",
                                   workloads=["dyyolo_copy_serve_b4"]))
    _, _, c, m = run.cell_entries(bench, "dyyolo_copy_serve_b4", tmp_path)
    assert c["name"] == "dyyolo_copy" and m["batch"] == 4
    names = [e["name"] for e in run.metrics_of(bench, "dyyolo_copy_serve_b4",
                                               "per_layer")]
    assert names == ["frames_seen"]
    assert run.reader("frames_seen", tmp_path)(
        {"window": {"attempted": 7}}) == 7


def test_a_new_kind_of_mix_and_entry_need_files_alone(tmp_path,
                                                      monkeypatch):
    for pkg, name, body in [
            (perfbench.kinds, "echo", "class Cell:\n    kind = 'echo'\n"),
            (perfbench.entries, "echo", "def build(*a):\n    return a\n")]:
        folder = tmp_path / pkg.__name__.split(".")[-1]
        folder.mkdir()
        (folder / f"{name}.py").write_text(body)
        monkeypatch.setattr(pkg, "__path__", [*pkg.__path__, str(folder)])
    assert drive.cell_class("echo").kind == "echo"
    assert drive.entry("echo").build(1, 2) == (1, 2)


@pytest.mark.parametrize("config, batch, size, fn", [
    ("dyyolo", 16, 640, "walk"), ("dyyolo", 1, 64, "walk"),
    ("dysoem_simfpn", 32, 1280, "soem_walk"),
    ("dysoem_simfpn", 2, 64, "soem_walk")])
def test_walks_equal_the_ports_roofline_table(config, batch, size, fn):
    from uavdet_tpu_torch.scripts import roofline_table
    conf = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    mine = walks.rows(conf, batch, size)
    theirs = getattr(roofline_table, fn)(batch, size)
    assert [tuple(r) for r in mine] == [tuple(r) for r in theirs]


def test_walk_totals():
    dy = json.loads((BENCH / "configs" / "dyyolo.json").read_text())
    so = json.loads((BENCH / "configs" / "dysoem_simfpn.json").read_text())
    assert walks.flops(dy, 16, 640) / 1e9 == pytest.approx(2470.9, abs=0.1)
    assert walks.flops(so, 32, 1280) / 1e9 == pytest.approx(8966, abs=1)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".")[0])
    return found


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN
    if "reference" in path.parts:   # the reference takes nothing of the port
        assert "uavdet_tpu_torch" not in _imports(path)


def test_a_run_loads_no_jax():
    code = ("import sys; import perfbench.run, perfbench.drive, "
            "perfbench.calibrate, perfbench.kinds.detect, "
            "perfbench.entries.detector; "
            "import uavdet_tpu_torch.inference; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            f"set({sorted(FORBIDDEN)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_without_the_program_beside_it_the_run_exits_with_no_result(
        tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "dyyolo_serve_b16", "--seed", "1", "--seconds", "1", "--trace", "0",
         "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout == ""
