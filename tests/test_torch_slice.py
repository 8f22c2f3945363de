"""Slice sampling in advancedmh_tpu_torch against advancedmh_tpu.

- ``SliceSampler.slice_move`` against JAX's ``step_batched`` driven by the
  random numbers JAX draws (the direction's normals per leaf, the Exp(1),
  U₀, V and the ``fold_in(k_shrink, i)`` trip uniforms): states and lp at
  1e-5, flags equal, on the flagship (lanes that exhaust a small
  ``max_shrink`` included) and a dict-params target;
- tests/test_slice.py's assertions on the torch engine, at their
  tolerances (more chains, fewer steps);
- the fused engine on its plain version (tests/test_pallas.py's slice
  checks at 1024 chains), a split run bit for bit, and the errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.models.targets import gaussian_mean_scale_model as jax_flagship
from advancedmh_tpu_torch import DensityModel, SliceSampler, sample
from advancedmh_tpu_torch.convert import correlated_gaussian_from_numpy
from advancedmh_tpu_torch.models import gaussian_mean_scale_model
from advancedmh_tpu_torch.utils.tree import tree_flatten

SIG = np.array([[1.5, 0.35], [0.35, 1.0]], dtype=np.float32)
P = np.linalg.inv(SIG).astype(np.float32)
MODEL = gaussian_mean_scale_model(data=np.random.default_rng(1234).normal(size=300),
                                  device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's threads in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=tol, atol=tol)


def _jax_slice_draws(key, leaves, C, max_shrink):
    """The numbers JAX's ``SliceSampler._step_impl`` draws from ``key``."""
    k_dir, k_y, k_int, k_split, k_shrink = jax.random.split(key, 5)
    z = [jax.random.normal(k, jnp.shape(leaf))
         for k, leaf in zip(jax.random.split(k_dir, len(leaves)), leaves)]
    trip_u = jnp.stack([jax.random.uniform(jax.random.fold_in(k_shrink, i), (C,))
                        for i in range(max_shrink)])
    return (z, jax.random.exponential(k_y, (C,)), jax.random.uniform(k_int, (C,)),
            jax.random.uniform(k_split, (C,)), trip_u)


def _t(a):
    return torch.as_tensor(np.array(a))


def _dict_models():
    jm = ref.DensityModel(lambda th: -0.5 * (th["a"] ** 2 + jnp.sum(th["b"] ** 2))
                          - 0.8 * th["a"] * th["b"][0])
    pm = DensityModel(lambda th: -0.5 * (th["a"] ** 2 + torch.sum(th["b"] ** 2))
                      - 0.8 * th["a"] * th["b"][0], device="cpu")
    return jm, pm


@pytest.mark.parametrize("target,width,max_stepout,max_shrink", [
    ("flagship", 0.5, 8, 32), ("flagship", 5.0, 3, 2), ("dict", 1.0, 8, 32),
])
def test_slice_move_matches_jax_on_its_noise(target, width, max_stepout, max_shrink):
    C = 64
    rng = np.random.default_rng(max_shrink)
    if target == "flagship":
        jm, pm = jax_flagship(), gaussian_mean_scale_model(device="cpu")
        x = np.stack([rng.normal(0.0, 0.3, C), rng.uniform(0.5, 2.0, C)], 1).astype(np.float32)
    else:
        jm, pm = _dict_models()
        x = {"a": rng.normal(size=C).astype(np.float32),
             "b": rng.normal(size=(C, 2)).astype(np.float32)}
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    lp = np.array(jax.vmap(jm.logdensity_fn)(jx))
    kw = dict(width=width, max_stepout=max_stepout, max_shrink=max_shrink)
    jspl, pspl = ref.SliceSampler(**kw), SliceSampler(**kw)
    state = ref.samplers.base.Transition(jx, jnp.asarray(lp), jnp.zeros(C, bool))
    px = jax.tree_util.tree_map(_t, x)
    for i in range(2):
        key = jax.random.fold_in(jax.random.key(3), i)
        z, e, u0, v, trip_u = _jax_slice_draws(key, jax.tree_util.tree_leaves(state.params), C,
                                               max_shrink)
        want, _ = jspl.step_batched(key, state, jm, (C,))
        got = pspl.slice_move(pm, px, _t(lp), [_t(a) for a in z], _t(lp) - _t(e), _t(u0),
                              _t(v), _t(trip_u), (C,))
        for a, b in zip(tree_flatten(got.params)[0], jax.tree_util.tree_leaves(want.params)):
            _close(a, b)
        _close(got.lp, want.lp)
        np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(want.accepted))
        if max_shrink == 2:
            assert not bool(got.accepted.all())  # some lanes exhaust their trips
        state = want
        px = jax.tree_util.tree_map(_t, want.params)
        lp = np.array(want.lp)


# ---- tests/test_slice.py on the torch engine --------------------------------------------


class TestSliceTorchEngine:
    def test_readme_model_moments(self):
        res = sample(MODEL, SliceSampler(width=0.5), 200, key=0, num_chains=512,
                     initial_params=torch.tensor([0.0, 1.0]), discard_initial=100)
        draws = res.transitions.params.reshape(-1, 2).numpy()
        assert abs(draws[:, 0].mean()) < 0.1
        assert abs(draws[:, 1].mean() - 1.0) < 0.1

    def test_covariance_recovery(self):
        Pt = torch.as_tensor(P)
        model = DensityModel(lambda x: -0.5 * x @ Pt @ x, dimension=2, device="cpu")
        res = sample(model, SliceSampler(width=1.5), 300, key=1, num_chains=512,
                     initial_params=torch.zeros(2), discard_initial=100)
        draws = res.transitions.params.reshape(-1, 2).numpy()
        np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.05)
        np.testing.assert_allclose(np.cov(draws.T), SIG, atol=0.12)

    @pytest.mark.parametrize("w", [0.1, 1.0, 10.0])
    def test_width_robustness(self, w):
        model = DensityModel(lambda x: -0.5 * torch.sum(x * x), dimension=1, device="cpu")
        res = sample(model, SliceSampler(width=w), 300, key=2, num_chains=256,
                     initial_params=torch.zeros(1), discard_initial=100)
        d = res.transitions.params.reshape(-1).numpy()
        assert abs(d.mean()) < 0.08, f"width={w}"
        np.testing.assert_allclose(d.var(), 1.0, rtol=0.12)

    def test_dict_params_one_direction(self):
        _, model = _dict_models()
        res = sample(model, SliceSampler(), 250, key=3, num_chains=256,
                     initial_params={"a": torch.zeros(()), "b": torch.zeros(2)},
                     discard_initial=100)
        a = res.transitions.params["a"].reshape(-1).numpy()
        b0 = res.transitions.params["b"].reshape(-1, 2)[:, 0].numpy()
        assert abs(np.corrcoef(a, b0)[0, 1] + 0.8) < 0.06

    def test_interface(self):
        with pytest.raises(ValueError, match="initial parameters"):
            sample(MODEL, SliceSampler(), 100, key=0)
        res = sample(MODEL, SliceSampler(), 200, key=4, num_chains=16,
                     initial_params=torch.tensor([0.0, 1.0]))
        assert bool(res.transitions.accepted[:, 1:].all())
        spl = SliceSampler()
        gen = torch.Generator().manual_seed(1)
        _, state = spl.init(gen, MODEL, torch.tensor([0.0, 1.0]))
        t, _ = spl.step(gen, state, MODEL)
        assert bool(t.accepted) and bool(torch.isfinite(t.lp))

    def test_impossible_target_keeps_state(self):
        impossible = DensityModel(lambda th: -torch.inf * torch.ones(()), device="cpu")
        spl = SliceSampler(max_shrink=4)
        gen = torch.Generator().manual_seed(0)
        _, state = spl.init(gen, impossible, torch.tensor([0.5]))
        t, _ = spl.step(gen, state, impossible)
        np.testing.assert_array_equal(t.params.numpy(), [0.5])
        assert not bool(t.accepted)


# ---- the fused engine on the plain version ----------------------------------------------


def test_fused_slice_readme_model():
    """tests/test_pallas.py::test_fused_slice_readme_model at 1024 chains:
    the 30-observation flagship's quadrature means E[μ] = 0.0268,
    E[σ] = 1.1810, and slices found within the budgets."""
    model = gaussian_mean_scale_model(device="cpu")
    res = sample(model, SliceSampler(width=0.5), 150, key=14, num_chains=1024, engine="fused",
                 discard_initial=100, initial_params=torch.tensor([0.0, 1.0]))
    draws = res.transitions.params.reshape(-1, 2).numpy()
    assert abs(draws[:, 0].mean() - 0.0268) < 0.03
    assert abs(draws[:, 1].mean() - 1.1810) < 0.03
    assert float(res.transitions.accepted.float().mean()) > 0.995


def test_fused_slice_covariance_and_thinning():
    res = sample(correlated_gaussian_from_numpy(SIG, device="cpu"), SliceSampler(width=1.5),
                 150, key=15, num_chains=1024, engine="fused", discard_initial=100, thinning=2,
                 initial_params=torch.zeros(2))
    draws = res.transitions.params.reshape(-1, 2).numpy()
    np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.05)
    np.testing.assert_allclose(np.cov(draws.T), SIG, atol=0.1)


def test_fused_split_run_is_bit_exact_and_caps():
    """A split run equals the unsplit one, and the JAX engine's budget caps
    (max_stepout 8, max_shrink 24) hold: a sampler asking for more runs as
    the capped one."""
    model = gaussian_mean_scale_model(device="cpu")
    kw = dict(key=2, num_chains=100, engine="fused", initial_params=torch.tensor([0.0, 1.0]))
    whole = sample(model, SliceSampler(width=0.5), 30, discard_initial=10, **kw)
    first = sample(model, SliceSampler(width=0.5), 12, discard_initial=10, **kw)
    rest = sample(model, SliceSampler(width=0.5), 18, discard_initial=1,
                  initial_state=first.final_state, iteration_offset=9 + 12, **kw)
    for f in ("params", "lp", "accepted"):
        assert torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(rest.transitions, f)], 1),
                           getattr(whole.transitions, f))
    capped = sample(model, SliceSampler(width=0.5, max_stepout=20, max_shrink=64), 30,
                    discard_initial=10, **kw)
    assert torch.equal(capped.transitions.params, whole.transitions.params)


def test_fused_errors():
    with pytest.raises(ValueError, match="initial parameters"):
        sample(gaussian_mean_scale_model(device="cpu"), SliceSampler(), 10, key=0,
               num_chains=8, engine="fused")
    with pytest.raises(ValueError, match="width"):
        sample(gaussian_mean_scale_model(device="cpu"), SliceSampler(width=0.0), 10, key=0,
               num_chains=8, engine="fused", initial_params=torch.tensor([0.0, 1.0]))
