"""CPU tests of the readers of the program's own spans: ``host_syncs``,
``front_end_ms`` and ``ess_stat_share``.

    python -m pytest portbench/tests -q
"""
from __future__ import annotations

import sys

import pytest

from portbench import harness, spec
from portbench.tests.test_portbench_harness import WORKLOADS, run_cpu
from portbench.window import CallRecord

NEW = ("host_syncs.ess", "front_end_ms.ess", "ess_stat_share.ess")
D = 2  # the flagship's parameters
# summary()'s five reads a parameter, the proposal's loc and the scale's copy
SYNCS_A_CALL = 5 * D + 1 + 1


def _reader(name):
    return spec.Metric(name, "", None).reader()


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_traced_run_reports_the_program_span_metrics(workload, capsys):
    res = run_cpu(workload, capsys, trace=1)
    assert res["correct"] is True
    for name in NEW:
        assert name in {m.name for m in spec.cell(workload).per_layer}
        assert res["metrics"][name]["value"] > 0.0, name
    assert res["metrics"]["host_syncs.ess"]["value"] == SYNCS_A_CALL
    assert res["metrics"]["host_syncs.ess"]["unit"] == "syncs/call"
    assert 0.0 < res["metrics"]["ess_stat_share.ess"]["value"] < 100.0


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
