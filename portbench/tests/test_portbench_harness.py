"""CPU tests of the benchmark: discovery by name, the window arithmetic, the
frozen yardstick, the import rules, and whole runs at a size a test run can
hold (the fused engine's plain versions stand in for the kernels on the
CPU): sound runs come out correct, the bfloat16 control and each fault the
cells can have come out not correct.

    python -m pytest portbench/tests -q
"""
from __future__ import annotations

import ast
import json
import math
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from portbench import harness, spec
from portbench.builder import build, config_objects
from portbench.reference import philox
from portbench.reference import rwmh as ref_rwmh
from portbench.tests import cpu_runs
from portbench.window import CallRecord, Window, percentile, run_window

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "fixture_gp"


# ---- discovery by name -----------------------------------------------------------------


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_parts_are_found_by_name(workload):
    cell = spec.cell(workload)
    assert cell.config_module().make_data and cell.driver().prepare
    assert set(cell.traffic["limits"]) and cell.chips == 1
    assert set(cell.traffic["cpu_test"]) <= set(cell.traffic) - {"cpu_test"}
    names = [m.name for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert names == [m["name"] for m in BENCH["end_to_end"]]  # every cell reports each
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.reader().read), m.name


def test_benchmark_file_keeps_the_contract_syntax():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    all_names = ([c["name"] for c in BENCH["configs"]] + WORKLOADS
                 + [m["name"] for m in metrics])
    assert all(name.match(n) for n in all_names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(unit.match(m["unit"]) for m in metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert w in moved.get("workloads", WORKLOADS)
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert (ROOT / "portbench" / "configs" / f"{c['name']}.py").is_file()
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['config']}.{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_metric_reader_may_be_shared_by_its_prefix():
    m = spec.Metric("idle.anything", "%", None)
    assert m.reader().__file__.endswith("metrics/idle.py")


# ---- the window ------------------------------------------------------------------------


def test_window_ends_at_the_last_call_started_before_the_deadline():
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731

    def call(i):
        t[0] += 0.4  # each call takes 0.4 s
        return {"ess": 10.0}, {}

    w = run_window(call, 1.0, clock=clock)
    # calls start at 0, 0.4, 0.8 (before 1.0) and end at 1.2: three calls
    assert len(w.records) == 3 and w.start == 0.0 and w.end == pytest.approx(1.2)
    assert w.seconds == pytest.approx(1.2)
    assert w.rate("ess") == pytest.approx(30.0 / 1.2)


def test_window_counts_failed_calls_and_keeps_their_time():
    t = [0.0]

    def call(i):
        t[0] += 0.5
        if i == 0:
            raise RuntimeError("boom")
        return {"ess": 1.0}, {}

    w = run_window(call, 1.0, clock=lambda: t[0])
    assert w.failed == 1 and w.attempted == 2 and w.start == 0.0
    assert w.seconds == pytest.approx(1.0)


def test_percentile_is_over_all_calls():
    recs = [CallRecord(0.0, float(i + 1), {}, {}) for i in range(100)]
    w = Window(recs, 0.0)
    assert percentile(w.durations(), 95.0) == pytest.approx(95.05)
    assert percentile([3.0], 95.0) == 3.0


# ---- the frozen yardstick --------------------------------------------------------------


def test_frozen_counts_equal_chip_smoke_at_the_cells_shapes():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    from portbench import bounds

    # flagship.rwmh and flagship.rwmh-thin
    for steps in (4500, 40500):
        assert bounds.bound_seconds(*bounds.rwmh_sample(16384, steps, 4000)) == pytest.approx(
            cs.bound("rwmh_sample", 16384, steps, 4000)[0], rel=1e-12)


# ---- what may be imported --------------------------------------------------------------


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_names_jax_or_the_jax_package():
    allowed = {"torch", "numpy", "advancedmh_tpu_torch", "portbench", "pytest", "chip_smoke",
               "__future__"} | set(sys.stdlib_module_names)
    for path in (ROOT / "portbench").rglob("*.py"):
        tops = set(_top_imports(path))
        assert not tops & set(harness.FORBIDDEN), path
        assert tops <= allowed, (path, tops - allowed)


def assert_references_import_nothing_of_the_program(root: Path) -> None:
    """Every ``portbench/reference/*.py`` under ``root``, imported in a fresh
    process from ``root``, loads neither the program nor JAX."""
    paths = sorted((root / "portbench" / "reference").glob("*.py"))
    for path in paths:
        assert "advancedmh_tpu_torch" not in set(_top_imports(path)), path
    mods = [f"portbench.reference.{p.stem}" for p in paths if p.stem != "__init__"]
    code = (f"import sys; import {', '.join(mods)}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"advancedmh_tpu_torch", *harness.FORBIDDEN}


def test_the_reference_imports_nothing_of_the_program():
    assert_references_import_nothing_of_the_program(ROOT)


def test_a_run_loads_no_jax():
    cpu_runs.run("flagship.rwmh")
    assert harness.forbidden_modules() == [] or "jax" in sys.modules  # the test process
    code = ("import sys; sys.argv = ['x']; from portbench import harness; "
            "harness.main(['--workload', 'flagship.rwmh', '--seed', '5', '--seconds', '0.2',"
            " '--trace', '0'], device='cpu', traffic_overrides={'num_chains': 32, "
            "'n_samples': 20, 'discard_initial': 10}); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    loaded = set(json.loads(out[-1].replace("'", '"')))
    assert "advancedmh_tpu_torch" in loaded and not loaded & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "advancedmh_tpu_torch_extra", sys)
    assert "advancedmh_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "advancedmh_tpu.sub", sys)
    assert "advancedmh_tpu" in harness.forbidden_modules()


def test_without_a_card_a_run_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rc = harness.main(["--workload", "flagship.rwmh", "--seed", "1", "--seconds", "1",
                       "--trace", "0"])
    assert rc == 2 and capsys.readouterr().out == ""


# ---- whole runs on the CPU -------------------------------------------------------------


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_run_is_correct(workload):
    res = cpu_runs.run(workload)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(spec.cell(workload).traffic["limits"])
    for m in spec.cell(workload).end_to_end:
        assert res["metrics"][m.name]["value"] > 0.0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_traced_run_reads_its_trace(workload):
    res = cpu_runs.run(workload, trace=1)
    assert res["correct"] is True
    assert res["device"]["window_s"] > 0.0 and "breakdown" in res
    assert set(res["metrics"]) <= {m.name for m in spec.cell(workload).per_layer}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_bfloat16_control_is_not_correct(workload):
    checks = cpu_runs.control_checks(workload)
    assert not all(c.ok for c in checks)
    assert min(c.value / c.limit for c in checks if not c.ok) > 1.0


# ---- faults planted under the timed path -----------------------------------------------


@pytest.mark.parametrize("fault", cpu_runs.FAULTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_fault_under_a_sampling_call_is_not_correct(workload, fault):
    res = cpu_runs.run(workload, fault=fault)
    assert res["correct"] is False, res["checks"]


def test_a_planted_fault_is_taken_out_again():
    import advancedmh_tpu_torch.runtime.fused as fused
    from advancedmh_tpu_torch.output.chains import Chains

    before = (fused.run, Chains.summary)
    for fault in cpu_runs.FAULTS:
        with pytest.raises(RuntimeError), cpu_runs.planted(fault):
            assert (fused.run, Chains.summary) != before
            raise RuntimeError
    assert (fused.run, Chains.summary) == before


@pytest.mark.parametrize("workload", WORKLOADS)
def test_set_up_warms_the_ess_fallback_where_the_traffic_asks(workload):
    from advancedmh_tpu_torch.diagnostics.ess import ess

    cell = spec.cell(workload)
    cell.traffic.update(cell.traffic["cpu_test"])
    cfgmod = cell.config_module()
    data = cfgmod.make_data(cell.config, 7, "cpu")
    before = ess.fft_fallbacks
    cell.driver().prepare(cell, cfgmod, data, "cpu")
    assert ess.fft_fallbacks - before == int(bool(cell.traffic.get("warm_ess_fallback")))


# ---- a new configuration and sampler join as new files and entries ---------------------


def test_the_rwmh_reference_replays_the_kernels_step_noise():
    chain = torch.tensor([0, 5, 16383])
    first = torch.tensor([1, 4501, (1 << 32) - 1])
    plan = ref_rwmh.plan(spec.cell("flagship.rwmh").traffic)
    got = ref_rwmh.noise(plan, 0x1234_5678_9ABC_DEF0, chain, first, 2, torch.float64, 4)
    want = philox.NoiseStream(0x1234_5678_9ABC_DEF0, chain, first, 2, torch.float64, 4)
    for _ in range(6):
        for a, b in zip(got.next(), want.next()):
            assert torch.equal(a, b)


AMH = types.SimpleNamespace(Normal=lambda *args: args)  # stands in for the program


class _Config:
    """A configuration module with ``program_objects`` (or without)."""

    def __init__(self, objects=None):
        if objects is not None:
            self.program_objects = lambda cfg, data, device: objects


@pytest.mark.parametrize("module, key", [(_Config(), "prior"), (_Config({"a": 1}), "prior"),
                                         (_Config({"prior": 1}), "scale")])
def test_a_missing_config_object_names_the_cell_and_the_key(module, key):
    cell = spec.cell("flagship.rwmh")
    objects = config_objects(cell, module, {}, "cpu")
    with pytest.raises(LookupError, match=rf"flagship\.rwmh.*'{key}'.*flagship\.py"):
        build({"type": "Normal", "args": [{"config": key}]}, AMH, "cpu", objects)


def test_config_objects_are_made_once_and_only_when_asked():
    made = []
    module = _Config()
    module.program_objects = lambda cfg, data, device: made.append(1) or {"s": 2.0, "t": 3.0}
    objects = config_objects(spec.cell("flagship.rwmh"), module, {}, "cpu")
    assert build([1.0, 2.0], None, "cpu", objects) == [1.0, 2.0] and made == []
    assert build([{"config": "s"}, {"config": "t"}], None, "cpu", objects) == [2.0, 3.0]
    assert made == [1]


@pytest.mark.parametrize("bounds, module", [(None, "rwmh"), ("rwmh", "rwmh")])
def test_the_traffic_may_name_its_bounds_module(bounds, module):
    cell = spec.cell("flagship.rwmh")
    if bounds is not None:
        cell.traffic["bounds"] = bounds
    cfgmod = cell.config_module()
    driver = cell.driver().prepare(cell, cfgmod, cfgmod.make_data(cell.config, 7, "cpu"), "cpu")
    assert driver.bounds.__name__ == f"portbench.bounds.{module}"


def test_a_bounds_module_the_traffic_names_must_exist():
    cell = spec.cell("flagship.rwmh")
    cell.traffic["bounds"] = "no_such_bounds"
    cfgmod = cell.config_module()
    with pytest.raises(ModuleNotFoundError, match="no_such_bounds"):
        cell.driver().prepare(cell, cfgmod, cfgmod.make_data(cell.config, 7, "cpu"), "cpu")


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _benchmark_with_fixture(tmp_path: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` with the fixture cell
    added as new files and appended entries only; checks that every file
    that was there is unchanged and the JSON differs by the entries alone."""
    copy = tmp_path / "bench"
    copy.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(copy)
    added = []
    for src in sorted(FIXTURE.rglob("*")):
        if src.is_file() and src.name != "entries.json" and "__pycache__" not in src.parts:
            dst = copy / "portbench" / src.relative_to(FIXTURE)
            assert not dst.exists(), f"the fixture would replace {dst}"
            shutil.copy(src, dst)
            added.append(str(dst.relative_to(copy)))
    old = json.loads((copy / "BENCHMARK.json").read_text())
    entries = json.loads((FIXTURE / "entries.json").read_text())
    new = dict(old)
    for k, v in entries.items():
        new[k] = old[k] + v
    (copy / "BENCHMARK.json").write_text(json.dumps(new, indent=1))

    after = _files(copy)
    assert sorted(set(after) - set(before)) == sorted(added)
    assert {"portbench/configs/fixture_gp.json", "portbench/configs/fixture_gp.py",
            "portbench/traffic/fixture_gp.ess.json", "portbench/reference/ess.py",
            "portbench/bounds/ess.py"} <= set(added)
    assert all(after[f] == before[f] for f in before if f != "BENCHMARK.json")
    reread = json.loads(after["BENCHMARK.json"])
    assert set(reread) == set(old)
    for k, v in old.items():
        assert reread[k] == (v + entries[k] if k in entries else v), k
    return copy


def _run_in_copy(copy: Path, workload: str) -> dict:
    """``cpu_runs.verdicts(workload)`` by the copy's harness, in a process
    that finds the copy's ``portbench`` first and the program in the repo."""
    out = subprocess.run([sys.executable, "-m", "portbench.tests.cpu_runs", "--workload",
                          workload], cwd=copy, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["harness"] == str(copy / "portbench")
    return res


def test_a_cell_of_another_sampler_joins_as_new_files_only(tmp_path):
    copy = _benchmark_with_fixture(tmp_path)
    traffic = json.loads((copy / "portbench/traffic/fixture_gp.ess.json").read_text())
    # its sampler takes an argument made from its configuration's data, and a
    # step draws more Philox words than the RWMH stream gives (2P + 1)
    assert traffic["sampler"]["args"] == [{"config": "prior"}]
    d, trips = 8, traffic["sampler"]["kwargs"]["max_shrink"]
    assert 2 * ((d + 1) // 2) + 2 + trips > 2 * ((d + 1) // 2) + 1
    assert_references_import_nothing_of_the_program(copy)

    res = _run_in_copy(copy, "fixture_gp.ess")
    assert res["sound"] is True, res["sound_checks"]
    assert res["traced"] is True
    # its per-layer metrics are new names read by shared readers
    assert res["traced_metrics"]["host_syncs.fixture_gp"]["value"] > 5 * d
    assert "idle.fixture_gp" in res["traced_metrics"]
    assert res["control"] is False, res["control_checks"]
    for fault in cpu_runs.FAULTS:
        assert res[fault] is False, (fault, res[f"{fault}_checks"])


RWMH_WORDS = '''

class _RwmhWords:
    """The RWMH stream's 2P + 1 words a step in place of this module's: the
    words past them (U_theta, the trips) read as its last, word 2P."""

    def __init__(self, stream, n_trips):
        self.stream, self.n_trips = stream, n_trips

    def next(self):
        z, logu, _ = self.stream.next()
        u = torch.exp(logu)
        return z, logu, u, u[:, None].expand(-1, self.n_trips)


def noise(plan_, seed, chain, first, d, dtype=torch.float64, chunk=1):
    return _RwmhWords(philox.NoiseStream(seed, chain, first, d, dtype, chunk),
                      plan_["max_shrink"])
'''


def test_the_fixture_is_judged_by_its_own_noise(tmp_path):
    copy = _benchmark_with_fixture(tmp_path)
    with open(copy / "portbench/reference/ess.py", "a") as f:
        f.write(RWMH_WORDS)
    res = _run_in_copy(copy, "fixture_gp.ess")
    mismatch = res["sound_checks"]["transition_mismatch"]
    assert mismatch["value"] > mismatch["limit"] and res["sound"] is False


# ---- on the card -----------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells' kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_short_run_on_the_card_is_correct(workload, card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                          "--seed", "3000000019", "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert all(math.isfinite(m["value"]) for m in res["metrics"].values())
