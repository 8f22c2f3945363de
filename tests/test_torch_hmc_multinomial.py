"""HamiltonianMC's multinomial trajectory sampling in advancedmh_tpu_torch:
tests/test_hmc.py::TestMultinomialTrajectory at small sizes, same
assertions (it runs on the torch engine only; the fused engine rejects it,
tests/test_torch_hmc.py)."""
import numpy as np
import pytest
import torch

from advancedmh_tpu_torch import DensityModel, HamiltonianMC, sample


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's threads in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestMultinomialTrajectory:
    def _model(self):
        var = torch.tensor([4.0, 0.25])
        return DensityModel(lambda x: -0.5 * torch.sum(x * x / var), device="cpu"), var

    def test_validation(self):
        with pytest.raises(ValueError, match="trajectory_sampling"):
            HamiltonianMC(0.1, 5, trajectory_sampling="nuts")

    def test_exact_at_coarse_eps(self):
        model, var = self._model()
        spl = HamiltonianMC(0.8, 6, trajectory_sampling="multinomial")
        res = sample(model, spl, 300, key=40, num_chains=512, initial_params=torch.zeros(2),
                     discard_initial=100)
        x = res.transitions.params.numpy()
        assert np.allclose(x.var(axis=(0, 1)), var.numpy(), rtol=0.05)
        assert np.abs(x.mean(axis=(0, 1)) / np.sqrt(var.numpy())).max() < 0.05

    def test_moves_more_than_endpoint(self):
        model, _ = self._model()
        kw = dict(key=41, num_chains=256, initial_params=torch.zeros(2), discard_initial=100)
        acc_end = float(sample(model, HamiltonianMC(0.8, 6), 200, **kw)
                        .transitions.accepted.float().mean())
        moved = float(sample(model, HamiltonianMC(0.8, 6, trajectory_sampling="multinomial"),
                             200, **kw).transitions.accepted.float().mean())
        assert moved > acc_end - 0.05

    def test_single_chain_and_pytree(self):
        def logdensity(p):
            return -0.5 * (torch.sum(p["a"] ** 2) + (p["b"] - 1.0) ** 2 / 0.25)

        spl = HamiltonianMC(0.3, 6, trajectory_sampling="multinomial")
        res = sample(DensityModel(logdensity, device="cpu"), spl, 1500, key=42,
                     initial_params={"a": torch.zeros(2), "b": torch.zeros(())},
                     discard_initial=300)
        b = res.transitions.params["b"].numpy()
        assert abs(b.mean() - 1.0) < 0.1
        assert abs(b.std() - 0.5) < 0.1
