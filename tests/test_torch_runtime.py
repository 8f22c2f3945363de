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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sample(MODEL, SPL, MCMCDistributed(), 10, 4)


@pytest.mark.parametrize("spl", [
    StaticMH(2, device="cpu"),
    MetropolisHastings(port.RandomWalkProposal(MvNormal(torch.tensor([0.1, 0.0])))),
    MetropolisHastings({"a": port.RandomWalkProposal(Normal(0.0, 1.0))}),
])
def test_unsupported_fused_sampler_raises(spl):
    with pytest.raises(ValueError, match="ROADMAP"):
        sample(MODEL, spl, 10, num_chains=4, engine="fused", initial_params=[0.0, 1.0])


def test_fused_needs_num_chains_and_initial_params():
    with pytest.raises(ValueError, match="num_chains"):
        sample(MODEL, SPL, 10, engine="fused", initial_params=[0.0, 1.0])
    with pytest.raises(ValueError, match="initial_params"):
        sample(MODEL, SPL, 10, engine="fused", num_chains=4)
