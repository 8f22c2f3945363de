"""CPU tests of the readers of the program's own spans: ``host_syncs``,
``front_end_ms`` and ``ess_stat_share``.

    python -m pytest portbench/tests -q
"""
from __future__ import annotations

import sys

import pytest

from portbench import harness, spec
from portbench.tests import cpu_runs
from portbench.tests.test_portbench_harness import WORKLOADS
from portbench.window import CallRecord

NEW = ("host_syncs.ess", "front_end_ms.ess", "ess_stat_share.ess")
READERS = tuple(n.split(".")[0] for n in NEW)


def syncs_a_call(workload: str) -> int:
    """The program's own count of host syncs (``utils/trace.py::host_syncs``)
    in one untraced call of ``workload`` at its ``cpu_test`` sizes."""
    from advancedmh_tpu_torch.utils.trace import host_syncs

    cell = spec.cell(workload)
    cell.traffic.update(cell.traffic["cpu_test"])
    cfgmod = cell.config_module()
    driver = cell.driver().prepare(cell, cfgmod, cfgmod.make_data(cell.config, 5, "cpu"), "cpu")
    before = host_syncs()
    driver.run(harness.call_key(5, 0), harness.Spans(tracing=False).span)
    return sum((host_syncs() - before).values())


def _reader(name):
    return spec.Metric(name, "", None).reader()


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_traced_run_reports_the_program_span_metrics(workload):
    cell = spec.cell(workload)
    res = cpu_runs.run(workload, trace=1)
    assert res["correct"] is True
    # the cell's names of the three readers (``<reader>.<suffix>``)
    mine = {m.name.split(".")[0]: m.name for m in cell.per_layer
            if m.name.split(".")[0] in READERS}
    assert set(mine) == set(READERS)
    for name in mine.values():
        assert res["metrics"][name]["value"] > 0.0, name
    assert res["metrics"][mine["host_syncs"]]["value"] == syncs_a_call(workload)
    assert res["metrics"][mine["host_syncs"]]["unit"] == "syncs/call"
    assert 0.0 < res["metrics"][mine["ess_stat_share"]]["value"] < 100.0


@pytest.mark.parametrize("workload", ["flagship.rwmh", "flagship.rwmh-thin"])
def test_a_flagship_call_syncs_five_times_a_parameter_and_twice_in_front(workload):
    # on the CPU summary() reads five times a parameter (D = 2); the front end
    # reads the proposal's loc and copies its scale
    assert syncs_a_call(workload) == 5 * 2 + 1 + 1


def _ctx(start, end):
    cell = spec.cell(WORKLOADS[0])
    return harness.Context(cell, 1.0, calls=[{"record": CallRecord(start, end, {}, {})}])


@pytest.mark.parametrize("name", NEW)
def test_a_reader_with_no_recorded_spans_returns_none(name):
    from advancedmh_tpu_torch.utils import trace

    trace.clear()
    assert _reader(name).read(_ctx(0.0, 1e9)) is None
    assert _reader(name).read(harness.Context(spec.cell(WORKLOADS[0]), 1.0)) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_tracing_module_gives_none(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "advancedmh_tpu_torch.utils.trace", None)
    assert _reader(name).read(_ctx(0.0, 1e9)) is None


def test_spans_are_assigned_to_the_call_that_holds_them():
    import time

    import torch

    import advancedmh_tpu_torch as amh
    from advancedmh_tpu_torch.models import gaussian_mean_scale_model
    from advancedmh_tpu_torch.utils import trace

    model = gaussian_mean_scale_model(device="cpu")
    sampler = amh.RWMH(amh.MvNormal(torch.zeros(2), scale=0.35))

    def call(key):
        return amh.sample(model, sampler, 20, key=key, num_chains=16, engine="fused",
                          discard_initial=10, initial_params=torch.tensor([0.0, 1.0]))

    trace.clear()
    with amh.tracing():
        t0 = time.perf_counter()
        call(3)
        t1 = time.perf_counter()
        call(4).to_chains().summary()  # outside the record
    # the first call's two front-end syncs alone, and no summary() in it
    assert _reader("host_syncs.ess").read(_ctx(t0, t1)) == 2.0
    assert _reader("front_end_ms.ess").read(_ctx(t0, t1)) > 0.0
    assert _reader("ess_stat_share.ess").read(_ctx(t0, t1)) is None
