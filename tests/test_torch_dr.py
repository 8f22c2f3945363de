"""Delayed rejection in advancedmh_tpu_torch against advancedmh_tpu.

- ``_log1m_exp`` against JAX's over a grid that holds both branches, the
  a ≥ 0 floor, −inf and NaN (1e-6);
- ``dr_move`` fed the proposals and Exp(1) draws JAX's key splits give,
  against JAX's ``step_batched`` (1e-5, decisions equal), starts outside the
  flagship's support among them;
- tests/test_dr.py's assertions on the torch engine, at their tolerances
  (fewer steps);
- the fused engine on its plain version: moments within Monte-Carlo error
  of the torch engine, a split run bit for bit, and the errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.models.targets import gaussian_mean_scale_model as jax_flagship
from advancedmh_tpu.proposals import propose as jax_propose
from advancedmh_tpu.samplers.dr import _log1m_exp as jax_log1m_exp
from advancedmh_tpu_torch import (DelayedRejection, DensityModel, MetropolisHastings, MvNormal,
                                  Normal, RandomWalkProposal, StaticProposal, ess_bulk, sample)
from advancedmh_tpu_torch.convert import transition_from_numpy
from advancedmh_tpu_torch.models import (gaussian_mean_scale_model, logdensity_batched)
from advancedmh_tpu_torch.ops import log1m_exp

COV = np.array([[1.5, 0.9], [0.9, 1.0]], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's threads in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=tol, atol=tol)


def _rw(s, d=2):
    return RandomWalkProposal(MvNormal(torch.zeros(d), scale=s), symmetric=True)


def _dr(s1, s2, d=2):
    return DelayedRejection(_rw(s1, d), _rw(s2, d))


def _jax_dr(s1, s2, d=2):
    rw = lambda s: ref.RandomWalkProposal(ref.MvNormal(jnp.zeros(d), scale=s), symmetric=True)
    return ref.DelayedRejection(rw(s1), rw(s2))


def _quadratic():
    P = torch.as_tensor(PREC)
    jP = jnp.asarray(PREC)
    return (DensityModel(lambda th: -0.5 * torch.einsum("...i,ij,...j->...", th, P, th),
                         dimension=2, device="cpu"),
            ref.DensityModel(lambda th: -0.5 * th @ jP @ th, dimension=2))


def test_log1m_exp_matches_jax():
    a = np.array([0.0, -1e-8, -1e-3, -0.69, -0.693, -0.7, -20.0, -50.0, 1.0, -np.inf, np.nan],
                 np.float32)
    got = log1m_exp(torch.as_tensor(a)).numpy()
    want = np.asarray(jax_log1m_exp(jnp.asarray(a)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == got[-3] == got[-1] == np.float32(-1e30) and got[-2] == 0.0


@pytest.mark.parametrize("target,s1,s2", [("flagship", 0.7, 0.12), ("quadratic", 8.0, 0.8)])
def test_dr_move_matches_jax_on_its_proposals(target, s1, s2):
    C = 64
    rng = np.random.default_rng(2)
    if target == "flagship":
        pm, jm = gaussian_mean_scale_model(device="cpu"), jax_flagship()
        x = np.stack([rng.normal(0.0, 0.3, C), rng.uniform(-0.3, 2.0, C)], 1).astype(np.float32)
    else:
        pm, jm = _quadratic()
        x = rng.normal(size=(C, 2)).astype(np.float32)
    lp = np.asarray(ref.models.density.logdensity_batched(jm, jnp.asarray(x)))
    assert target == "quadratic" or np.isinf(lp).any()
    jst = ref.Transition(jnp.asarray(x), jnp.asarray(lp), jnp.zeros(C, bool))
    pst = transition_from_numpy(x, lp, np.zeros(C, bool), device="cpu")
    jspl, pspl = _jax_dr(s1, s2), _dr(s1, s2)
    jstep = jax.jit(lambda k, st: jspl.step_batched(k, st, jm, (C,))[0])
    for i in range(5):
        key = jax.random.fold_in(jax.random.key(3), i)
        key_p1, key_a1, key_p2, key_a2 = jax.random.split(key, 4)
        y1 = jax_propose(key_p1, jspl.first, jst.params, (C,))
        y2 = jax_propose(key_p2, jspl.second, jst.params, (C,))
        e1, e2 = (jax.random.exponential(k, (C,)) for k in (key_a1, key_a2))
        jst = jstep(key, jst)
        y1, y2 = _t(y1), _t(y2)
        pst = pspl.dr_move(pst.params, pst.lp, y1, logdensity_batched(pm, y1), y2,
                           logdensity_batched(pm, y2), _t(e1), _t(e2), (C,))
        np.testing.assert_array_equal(pst.accepted.numpy(), np.asarray(jst.accepted))
        _close(pst.params, jst.params, 1e-5)
        _close(pst.lp, jst.lp, 1e-5)


# ---- tests/test_dr.py on the torch engine ---------------------------------------------


class TestDRTorchEngine:
    def test_readme_model_moments(self):
        model = gaussian_mean_scale_model(n_obs=300, device="cpu")
        res = sample(model, _dr(0.7, 0.12), 1000, key=0, num_chains=64,
                     initial_params=torch.tensor([0.0, 1.0]), discard_initial=300)
        draws = res.transitions.params.reshape(-1, 2).numpy()
        assert abs(draws[:, 0].mean()) < 0.1
        assert abs(draws[:, 1].mean() - 1.0) < 0.1

    def test_stage2_correction_exact(self):
        """A bold stage 1 (scale 8, nearly never accepted) sends almost every
        accepted move through stage 2: a wrong (1 − α₁) ratio or a missing
        q₁ term would bias the moments."""
        model, _ = _quadratic()
        res = sample(model, _dr(8.0, 0.8), 1500, key=1, num_chains=256,
                     initial_params=torch.zeros(2), discard_initial=500)
        draws = res.transitions.params.reshape(-1, 2).numpy()
        np.testing.assert_allclose(draws.mean(axis=0), 0.0, atol=0.05)
        np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.12)

    def test_single_chain_step_path(self):
        model = DensityModel(lambda th: Normal(0.0, 1.0).log_prob(th[..., 0]), dimension=1,
                             device="cpu")
        res = sample(model, _dr(2.5, 0.5, d=1), 6000, key=2, initial_params=torch.zeros(1),
                     discard_initial=500)
        x = res.transitions.params.reshape(-1).numpy()
        assert abs(x.mean()) < 0.06
        assert abs(x.var() - 1.0) < 0.12

    def test_second_stage_rescues_acceptance(self):
        model = gaussian_mean_scale_model(device="cpu")
        kw = dict(num_chains=128, initial_params=torch.tensor([0.0, 1.0]), discard_initial=200)
        acc_mh = float(sample(model, MetropolisHastings(_rw(8.0)), 300, key=3,
                              **kw).transitions.accepted.float().mean())
        acc_dr = float(sample(model, _dr(8.0, 0.2), 300, key=3,
                              **kw).transitions.accepted.float().mean())
        assert acc_mh < 0.05 and acc_dr > 0.2

    def test_asymmetric_second_raises(self):
        with pytest.raises(ValueError, match="symmetric second"):
            DelayedRejection(_rw(1.0), StaticProposal(MvNormal(torch.zeros(2), scale=1.0)))

    def test_pytree_proposals(self):
        model = DensityModel(lambda th: Normal(0.0, 1.0).log_prob(th["a"])
                             + Normal(2.0, 0.5).log_prob(th["b"]), device="cpu")
        leaf = lambda s: RandomWalkProposal(Normal(0.0, s), symmetric=True)
        spl = DelayedRejection({"a": leaf(1.0), "b": leaf(1.0)}, {"a": leaf(0.2), "b": leaf(0.2)})
        res = sample(model, spl, 1000, key=5, num_chains=32, discard_initial=200,
                     initial_params={"a": torch.zeros(()), "b": 2.0 * torch.ones(())})
        assert abs(float(res.transitions.params["a"].mean())) < 0.08
        assert abs(float(res.transitions.params["b"].mean()) - 2.0) < 0.06


# ---- the fused engine on its plain version --------------------------------------------


def test_fused_dr_moments_match_torch_engine():
    model = gaussian_mean_scale_model(device="cpu")
    kw = dict(num_chains=256, initial_params=torch.tensor([0.0, 1.0]), discard_initial=300)
    fused = sample(model, _dr(0.5, 0.1), 800, key=11, engine="fused", **kw)
    torch_ = sample(model, _dr(0.5, 0.1), 800, key=12, **kw)
    a, b = fused.transitions.params, torch_.transitions.params
    for j in range(2):
        se = [float(torch.var(x[..., j])) / float(ess_bulk(x[..., j].T)) for x in (a, b)]
        assert abs(float(a[..., j].mean() - b[..., j].mean())) < 4.0 * (se[0] + se[1]) ** 0.5
    assert 0.5 < float(fused.transitions.accepted.float().mean()) < 0.95


def test_fused_dr_split_run_is_bit_exact():
    model = gaussian_mean_scale_model(device="cpu")
    kw = dict(key=3, num_chains=100, engine="fused", thinning=3,
              initial_params=torch.tensor([0.0, 1.0]))
    whole = sample(model, _dr(0.5, 0.1), 20, discard_initial=6, **kw)
    first = sample(model, _dr(0.5, 0.1), 8, discard_initial=6, **kw)
    rest = sample(model, _dr(0.5, 0.1), 12, discard_initial=3, initial_state=first.final_state,
                  iteration_offset=3 + 24, **kw)
    for f in ("params", "lp", "accepted"):
        assert torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(rest.transitions, f)], 1),
                           getattr(whole.transitions, f))


def test_fused_dr_errors():
    model = gaussian_mean_scale_model(device="cpu")
    full = RandomWalkProposal(MvNormal(torch.zeros(2), scale_tril=torch.eye(2)), symmetric=True)
    kw = dict(key=0, num_chains=8, engine="fused", initial_params=torch.tensor([0.0, 1.0]))
    with pytest.raises(ValueError, match="full-covariance"):
        sample(model, DelayedRejection(full, _rw(0.1)), 10, **kw)
    leaf = RandomWalkProposal(Normal(0.0, 0.5), symmetric=True)
    with pytest.raises(ValueError, match="single RandomWalkProposal leaf"):
        sample(model, DelayedRejection([leaf, leaf], _rw(0.1)), 10, **kw)
