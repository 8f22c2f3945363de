"""The sampling runtime of advancedmh_tpu_torch: schedule contract, output
shapes and keys, absolute-iteration RNG, and the errors of what is not
ported (≙ tests/test_runtime.py of the JAX package)."""
import itertools

import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
import advancedmh_tpu_torch as port
from advancedmh_tpu_torch import (
    Chains,
    DensityModel,
    MCMCDistributed,
    MCMCSerial,
    MCMCThreads,
    MetropolisHastings,
    MvNormal,
    Normal,
    RWMH,
    Schedule,
    StaticMH,
    StaticProposal,
    StructArray,
    sample,
)
from advancedmh_tpu_torch.models import gaussian_mean_scale_model
from advancedmh_tpu_torch.samplers.base import Sampler

MODEL = gaussian_mean_scale_model(device="cpu")
SPL = RWMH(MvNormal(torch.zeros(2), scale=0.3))


@pytest.mark.parametrize(
    "n,warmup,discard,thin",
    list(itertools.product([1, 7], [0, 3], [None, 0, 5], [1, 4])),
)
def test_schedule_matches_jax(n, warmup, discard, thin):
    p = Schedule(n_samples=n, num_warmup=warmup, discard_initial=discard, thinning=thin)
    r = ref.Schedule(n_samples=n, num_warmup=warmup, discard_initial=discard, thinning=thin)
    assert (p.discard_initial, p.total_steps, p.start) == (r.discard_initial, r.total_steps, r.start)
    assert p.iterations() == r.iterations()
    # the fused engines emit the state after burn + (k+1)·thinning steps: the
    # standard schedule's iterations wherever the init state is not one of them
    fused_iterations = [p.burn + (k + 1) * thin + 1 for k in range(n)]
    assert (fused_iterations == list(p.iterations())) == (p.discard_initial >= thin)


def test_schedule_validation():
    for kw in (dict(n_samples=0), dict(n_samples=10, thinning=0),
               dict(n_samples=10, discard_initial=-1)):
        with pytest.raises(ValueError):
            Schedule(**kw)
        with pytest.raises(ValueError):
            ref.Schedule(**kw)


class TestOutputKeys:
    """≙ tests/test_runtime.py::TestOutputKeys: keys follow the proposal."""

    def test_scalar_proposal(self):
        m = DensityModel(lambda x: Normal(x, 1.0).log_prob(torch.tensor(1.0)), device="cpu")
        c = sample(m, MetropolisHastings(StaticProposal(Normal(0.0, 1.0))),
                   100, key=0, chain_type="namedtuples")
        assert set(c[0].keys()) == {"param_1", "lp"} and len(c) == 100

    def test_array_proposal(self):
        m = DensityModel(lambda x: Normal(x[0], torch.abs(x[1]) + 0.5).log_prob(torch.tensor(1.0)),
                         device="cpu")
        c = sample(m, MetropolisHastings(StaticProposal([Normal(0.0, 1.0), Normal(1.0, 2.0)])),
                   100, key=0, chain_type="namedtuples")
        assert set(c[0].keys()) == {"param_1", "param_2", "lp"}

    def test_dict_proposal(self):
        m = DensityModel(lambda x: Normal(x["a"], torch.abs(x["b"]) + 0.5).log_prob(torch.tensor(1.0)),
                         device="cpu")
        c = sample(m, MetropolisHastings({"a": StaticProposal(Normal(0.0, 1.0)),
                                          "b": StaticProposal(Normal(1.0, 2.0))}),
                   100, key=0, chain_type="namedtuples")
        assert set(c[0].keys()) == {"a", "b", "lp"}

    def test_functional_proposal(self):
        m = DensityModel(lambda x: Normal(x, 1.0).log_prob(torch.tensor(1.0)), device="cpu")
        c = sample(m, MetropolisHastings(StaticProposal(lambda x=1.0: Normal(x, 1.0))),
                   100, key=0, chain_type="namedtuples")
        assert set(c[0].keys()) == {"param_1", "lp"}

    def test_dict_proposal_batched_chains(self):
        m = DensityModel(lambda x: Normal(x["a"], 1.0).log_prob(torch.tensor(1.0))
                         + Normal(x["b"], 1.0).log_prob(torch.tensor(0.0)), device="cpu")
        c = sample(m, MetropolisHastings({"a": StaticProposal(Normal(0.0, 1.0)),
                                          "b": StaticProposal(Normal(1.0, 2.0))}),
                   20, key=0, num_chains=3, chain_type="chains")
        assert c.names == ["a", "b"] and c.values.shape == (20, 2, 3)


class TestInitialParams:
    def test_honored_as_first_sample(self):
        spl = StaticMH([Normal(0.0, 1.0), Normal(0.0, 1.0)])
        res = sample(MODEL, spl, 10, key=0, initial_params=[0.4, 1.2])
        np.testing.assert_allclose(res.transitions.params[0].numpy(), [0.4, 1.2])

    def test_batched_initial_params(self):
        vals = np.asarray([[0.1, 1.0], [0.2, 1.1], [0.3, 1.2]], np.float32)
        res = sample(MODEL, StaticMH([Normal(0.0, 1.0), Normal(0.0, 1.0)]), 5, key=0,
                     num_chains=3, initial_params=vals, initial_params_batched=True)
        np.testing.assert_allclose(res.transitions.params[:, 0, :].numpy(), vals)


@pytest.mark.parametrize("num_chains", [None, 4])
def test_output_shapes(num_chains):
    res = sample(MODEL, SPL, 11, key=1, num_chains=num_chains, discard_initial=3,
                 thinning=2, initial_params=[0.0, 1.0])
    lead = () if num_chains is None else (num_chains,)
    assert tuple(res.transitions.params.shape) == lead + (11, 2)
    assert tuple(res.transitions.lp.shape) == lead + (11,)
    assert res.transitions.accepted.dtype == torch.bool


def test_chains_bundle_range_and_shapes():
    c = sample(MODEL, SPL, 100, key=0, discard_initial=25, thinning=4,
               initial_params=[0.0, 1.0], chain_type="chains", param_names=["μ", "σ"])
    assert isinstance(c, Chains)
    assert c.range == range(26, 26 + 4 * 100, 4)
    assert c.values.shape == (100, 2, 1) and c.array.shape == (100, 3, 1)
    assert c.names == ["μ", "σ"] and c.internals == ["lp"]
    sa = sample(MODEL, SPL, 50, key=0, initial_params=[0.0, 1.0],
                chain_type="structarray", param_names=["mu", "sigma"])
    assert isinstance(sa, StructArray) and sa.mu.shape == (50,)
    assert StructArray.cat(sa, sa).mu.shape == (100,)
    c2 = sample(MODEL, SPL, 100, key=1, num_chains=3, discard_initial=25, thinning=4,
                initial_params=[0.0, 1.0], chain_type="chains", param_names=["μ", "σ"])
    assert Chains.cat(c, c2).n_chains == 4


@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_absolute_iteration_split_run_is_bit_identical(engine):
    """Steps 1..2k in one run equal steps 1..k then k+1..2k resumed from
    the saved state with iteration_offset=k."""
    k = 12
    kw = dict(key=5, num_chains=6, engine=engine)
    if engine == "fused":  # sample j is the state after j steps
        kw["discard_initial"] = 1
        n_first, n_whole, skip = k, 2 * k, 0
    else:  # sample 1 is the init (or resumed) state, sample j+1 after j steps
        n_first, n_whole, skip = k + 1, 2 * k + 1, 1
    whole = sample(MODEL, SPL, n_whole, initial_params=[0.0, 1.0], **kw)
    first = sample(MODEL, SPL, n_first, initial_params=[0.0, 1.0], **kw)
    second = sample(MODEL, SPL, n_first, initial_state=first.final_state,
                    iteration_offset=k, **kw)
    joined = torch.cat([first.transitions.params,
                        second.transitions.params[:, skip:]], dim=1)
    assert torch.equal(joined, whole.transitions.params)


def test_same_key_same_result_and_keys_differ():
    a = sample(MODEL, SPL, 30, key=3, num_chains=4, initial_params=[0.0, 1.0])
    b = sample(MODEL, SPL, 30, key=3, num_chains=4, initial_params=[0.0, 1.0])
    c = sample(MODEL, SPL, 30, key=4, num_chains=4, initial_params=[0.0, 1.0])
    assert torch.equal(a.transitions.params, b.transitions.params)
    assert not torch.equal(a.transitions.params, c.transitions.params)


def test_positional_ensemble_form_and_serial():
    c = sample(MODEL, SPL, MCMCThreads(), 10, 3, initial_params=[0.0, 1.0],
               chain_type="chains")
    assert c.values.shape == (10, 2, 3)
    s = sample(MODEL, SPL, MCMCSerial(), 10, 3, initial_params=[0.0, 1.0])
    assert tuple(s.transitions.params.shape) == (3, 10, 2)


def test_xla_engine_raises_naming_torch():
    with pytest.raises(ValueError, match="torch"):
        sample(MODEL, SPL, 10, engine="xla")


def test_mcmc_distributed_raises():
    with pytest.raises(NotImplementedError, match="MCMCThreads"):
        sample(MODEL, SPL, MCMCDistributed(), 10, 4)


@pytest.mark.parametrize("spl", [
    StaticMH(2, device="cpu"),
    MetropolisHastings(port.RandomWalkProposal(MvNormal(torch.tensor([0.1, 0.0])))),
    MetropolisHastings({"a": port.RandomWalkProposal(Normal(0.0, 1.0))}),
])
def test_unsupported_fused_sampler_raises(spl):
    with pytest.raises(ValueError, match="engine='torch'"):
        sample(MODEL, spl, 10, num_chains=4, engine="fused", initial_params=[0.0, 1.0])


def test_fused_needs_num_chains_and_initial_params():
    with pytest.raises(ValueError, match="num_chains"):
        sample(MODEL, SPL, 10, engine="fused", initial_params=[0.0, 1.0])
    with pytest.raises(ValueError, match="initial_params"):
        sample(MODEL, SPL, 10, engine="fused", num_chains=4)


# ---- the fused engine's table of runners ------------------------------------


# The runner each sampler class got from sample()'s ladder of isinstance
# branches before the table replaced it; DR and MTM ran inside the RWMH
# runner.
LADDER = {
    "MetropolisHastings": "sample_fused",
    "MultipleTryMetropolis": "sample_fused_mtm",
    "DelayedRejection": "sample_fused_dr",
    "MALA": "sample_fused_mala",
    "RobustAdaptiveMetropolis": "sample_fused_ram",
    "Ensemble": "sample_fused_emcee",
    "StepSizeAdaptation": "sample_fused_adapt_rwmh",
    "HamiltonianMC": "sample_fused_hmc",
    "AdaptiveHMC": "sample_fused_adaptive_hmc",
    "ChEESHMC": "sample_fused_chees",
    "MEADS": "sample_fused_meads",
    "SliceSampler": "sample_fused_slice",
    "EllipticalSlice": "sample_fused_ess",
    "Barker": "sample_fused_barker",
    "PreconditionedCrankNicolson": "sample_fused_pcn",
    "AdaptiveMetropolis": "sample_fused_am",
    "DRAM": "sample_fused_am",
    "ReplicaExchange": "sample_fused_tempering",
    "DifferentialEvolution": "sample_fused_demc",
}


class _Unported(Sampler):
    pass


@pytest.mark.parametrize("name", sorted(LADDER))
def test_fused_table_resolves_each_sampler_class(name):
    from advancedmh_tpu_torch.runtime import fused

    cls = getattr(port, name)
    assert {c.__name__ for c in fused.RUNNERS} == set(LADDER)
    runner = fused.runner_of(cls.__new__(cls))  # resolution reads the class alone
    assert runner.run.__name__ == LADDER[name]
    assert runner.population == (name in ("Ensemble", "DifferentialEvolution"))
    # a subclass takes its nearest registered class's runner
    sub = type("Sub", (cls,), {})
    assert fused.runner_of(sub.__new__(sub)) == runner
    with pytest.raises(ValueError, match="engine='torch'") as err:
        fused.run(MODEL, _Unported(), Schedule(4), key=0, num_chains=2,
                  initial_params=None, initial_state=None, iteration_offset=0)
    assert name in str(err.value) and "_Unported" in str(err.value)


@pytest.mark.parametrize("warmup,discard,thin,resume,error", [
    (5, 5, 1, False, None),
    (5, 7, 2, False, "discard_initial == num_warmup"),
    (0, 3, 3, True, None),
    (2, 2, 2, True, "chunk-resume schedule"),
    (0, 1, 3, True, "chunk-resume schedule"),
])
def test_fused_adaptive_schedule_check(warmup, discard, thin, resume, error):
    s = Schedule(4, num_warmup=warmup, discard_initial=discard, thinning=thin)
    if error is None:
        s.check_adaptive("RAM", resume)
    else:
        with pytest.raises(ValueError, match=f"fused RAM .*{error}"):
            s.check_adaptive("RAM", resume)
