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
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import control, harness, spec
from portbench.window import CallRecord, Window, percentile, run_window

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]

# a size a test run can hold, per traffic mix
TINY = {
    "flagship.rwmh": {"num_chains": 64, "n_samples": 60, "discard_initial": 20},
    "flagship.rwmh-thin": {"num_chains": 64, "n_samples": 30, "discard_initial": 20},
}


def run_cpu(workload, capsys, seed=4_294_967_311, trace=0, seconds=0.3):
    rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu",
                      traffic_overrides=TINY[workload])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


# ---- discovery by name -----------------------------------------------------------------


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_parts_are_found_by_name(workload):
    cell = spec.cell(workload)
    assert cell.config_module().make_data and cell.driver().prepare
    assert set(cell.traffic["limits"]) and cell.chips == 1
    names = [m.name for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
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


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert "advancedmh_tpu_torch" not in set(_top_imports(path)), path
    code = ("import sys; import portbench.reference.philox, portbench.reference.rwmh, "
            "portbench.reference.summary, portbench.reference.flagship; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"advancedmh_tpu_torch", *harness.FORBIDDEN}


def test_a_run_loads_no_jax(capsys):
    run_cpu("flagship.rwmh", capsys)
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
def test_a_sound_run_is_correct(workload, capsys):
    res = run_cpu(workload, capsys)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(spec.cell(workload).traffic["limits"])
    for m in spec.cell(workload).end_to_end:
        assert res["metrics"][m.name]["value"] > 0.0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_traced_run_reads_its_trace(workload, capsys):
    res = run_cpu(workload, capsys, trace=1)
    assert res["correct"] is True
    assert res["device"]["window_s"] > 0.0 and "breakdown" in res
    assert set(res["metrics"]) <= {m.name for m in spec.cell(workload).per_layer}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_bfloat16_control_is_not_correct(workload):
    checks = control.run(workload, 2_147_483_659, torch.device("cpu"), TINY[workload])
    assert not all(c.ok for c in checks)
    assert min(c.value / c.limit for c in checks if not c.ok) > 1.0


# ---- faults planted under the timed path -----------------------------------------------


def _unchanged(fn):
    """A step that returns its state unchanged: every draw is the start."""
    def broken(tile_fn, density, params_t, lp, *args, **kw):
        out = fn(tile_fn, density, params_t, lp, *args, **kw)
        n = out[0].shape[0]
        return (params_t[None].expand(n, *params_t.shape).clone(),
                lp[None].expand(n, *lp.shape).clone(), torch.zeros_like(out[2]), *out[3:])
    return broken


def _half(fn):
    """Half of the batch left out: the second half of the chains is never run."""
    def broken(tile_fn, density, params_t, *args, **kw):
        out = fn(tile_fn, density, params_t, *args, **kw)
        half = params_t.shape[1] // 2
        return tuple(_zero_tail(o, half) for o in out)
    return broken


def _zero_tail(t, half):
    t = t.clone()
    t[..., half:] = 0.0
    return t


def _altered(fn):
    """An answer altered where it is produced."""
    def broken(*args, **kw):
        out = fn(*args, **kw)
        return (out[0] * (1.0 + 1e-3) + 1e-3, *out[1:])
    return broken


def _half_summary(orig):
    """The statistics taken over half of the chains."""
    def broken(self):
        half = type(self)(self.values[:, :, : self.n_chains // 2],
                          self.lp[:, : self.n_chains // 2], self.names)
        return orig(half)
    return broken


SAMPLE_KERNELS = {"flagship.rwmh": "fused_rwmh_sample", "flagship.rwmh-thin": "fused_rwmh_sample"}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "half_summary"])
@pytest.mark.parametrize("workload", sorted(SAMPLE_KERNELS))
def test_a_fault_under_a_sampling_call_is_not_correct(workload, fault, capsys, monkeypatch):
    import advancedmh_tpu_torch.runtime.fused as fused
    from advancedmh_tpu_torch.output.chains import Chains

    name = SAMPLE_KERNELS[workload]
    if fault == "half_summary":
        monkeypatch.setattr(Chains, "summary", _half_summary(Chains.summary))
    else:
        wrap = {"unchanged": _unchanged, "half": _half, "altered": _altered}[fault]
        monkeypatch.setattr(fused, name, wrap(getattr(fused, name)))
    res = run_cpu(workload, capsys)
    assert res["correct"] is False, res["checks"]


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
