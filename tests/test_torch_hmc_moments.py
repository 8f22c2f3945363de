"""HamiltonianMC in advancedmh_tpu_torch: tests/test_hmc.py's moment and
physics tests on the torch engine at small sizes, same assertions (the
kernel-level and fused-engine tests are in tests/test_torch_hmc.py)."""
import numpy as np
import pytest
import torch

from advancedmh_tpu_torch import DensityModel, HamiltonianMC, StepSizeAdaptation, ess, sample
from advancedmh_tpu_torch.convert import (
    correlated_gaussian_from_numpy,
    gaussian_mean_scale_from_numpy,
)

COV = np.asarray([[1.5, 0.35], [0.35, 1.0]], np.float32)
MODEL = gaussian_mean_scale_from_numpy(np.random.default_rng(1234).normal(size=300),
                                       device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's threads in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corr(cov=COV):
    return correlated_gaussian_from_numpy(cov, device="cpu")


# ---- tests/test_hmc.py at small sizes ----------------------------------------------


class TestBasic:
    def test_requires_initial_params(self):
        with pytest.raises(ValueError, match="initial parameters"):
            sample(MODEL, HamiltonianMC(0.1, 5), 100, key=0)

    def test_validation(self):
        with pytest.raises(ValueError, match="step_size"):
            HamiltonianMC(-0.1, 5)
        with pytest.raises(ValueError, match="n_leapfrog"):
            HamiltonianMC(0.1, 0)

    def test_posterior_moments_gaussian_model(self):
        chains = sample(MODEL, HamiltonianMC(0.05, 8), 300, key=1, num_chains=16,
                        initial_params=torch.ones(2), discard_initial=100,
                        chain_type="chains", param_names=["μ", "σ"])
        assert abs(float(chains["μ"].mean())) < 0.1
        assert abs(float(chains["σ"].mean()) - 1.0) < 0.1

    def test_covariance_recovery_quadratic(self):
        # ε·L = 4 is near half the period of the wide direction, where the
        # exact flow maps x to −x: mixing there comes from the leapfrog's
        # error, so the run keeps tests/test_hmc.py's size
        chains = sample(_corr(), HamiltonianMC(0.4, 10), 2000, key=2, num_chains=32,
                        initial_params=torch.zeros(2), discard_initial=500,
                        chain_type="chains")
        flat = chains.values.permute(0, 2, 1).reshape(-1, 2).numpy()
        assert np.abs(np.cov(flat.T) - COV).max() < 0.2


class TestPhysics:
    def test_energy_conservation_small_eps(self):
        res = sample(_corr(), HamiltonianMC(0.01, 5), 400, key=3, num_chains=8,
                     initial_params=torch.zeros(2))
        assert float(res.transitions.accepted.float().mean()) > 0.995

    def test_coarse_eps_still_unbiased(self):
        res = sample(_corr(), HamiltonianMC(1.7, 10), 500, key=4, num_chains=64,
                     initial_params=torch.zeros(2), discard_initial=100)
        acc = float(res.transitions.accepted.float().mean())
        assert 0.2 < acc < 0.8
        draws = res.transitions.params.reshape(-1, 2).numpy()
        assert np.abs(draws.mean(axis=0)).max() < 0.1

    def test_inverse_mass_preconditioning(self):
        model = _corr(np.diag([400.0, 1.0]))
        common = dict(key=5, num_chains=16, initial_params=torch.zeros(2), discard_initial=100)
        es = []
        for minv in (None, torch.tensor([400.0, 1.0])):
            res = sample(model, HamiltonianMC(0.5, 6, inverse_mass=minv), 300, **common)
            es.append(float(ess(res.transitions.params[:, :, 0].T)))
        assert es[1] > 5.0 * es[0]

    def test_pytree_params(self):
        def logdensity(p):
            return -0.5 * (torch.sum(p["a"] ** 2) + torch.sum((p["b"] - 1.0) ** 2) / 0.25)

        # ε·L = 1.6 is near half of b's period (as above): full length
        res = sample(DensityModel(logdensity, device="cpu"), HamiltonianMC(0.2, 8), 2000,
                     key=6, num_chains=8,
                     initial_params={"a": torch.zeros(2), "b": torch.zeros(())},
                     discard_initial=300)
        a = res.transitions.params["a"].numpy()
        b = res.transitions.params["b"].numpy()
        assert np.abs(a.mean(axis=(0, 1))).max() < 0.1
        assert abs(b.mean() - 1.0) < 0.1
        assert abs(b.std() - 0.5) < 0.1

    def test_batched_matches_single_chain_distribution(self):
        res = sample(_corr(), HamiltonianMC(0.3, 6), 400, key=7, num_chains=32,
                     initial_params=torch.zeros(2), discard_initial=100)
        draws = res.transitions.params.reshape(-1, 2).numpy()
        assert np.abs(np.cov(draws.T) - COV).max() < 0.25


def test_step_size_adaptation_hits_target():
    spl = StepSizeAdaptation.hmc(n_leapfrog=5, initial_step_size=0.02)
    res = sample(_corr(), spl, 600, key=8, num_chains=16, num_warmup=600,
                 initial_params=torch.zeros(2), discard_initial=600)
    assert abs(float(res.transitions.accepted.float().mean()) - 0.65) < 0.12
    draws = res.transitions.params.reshape(-1, 2).numpy()
    assert np.abs(draws.mean(axis=0)).max() < 0.15
