"""advancedmh_tpu_torch distributions against advancedmh_tpu on shared inputs.

Inputs come from a seeded numpy generator and go to both packages as numpy
arrays. Log-densities are deterministic: atol 1e-5 in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
import advancedmh_tpu_torch as port
from advancedmh_tpu_torch.utils import generator

ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


@pytest.fixture
def rng():
    return np.random.default_rng(20240611)


def test_normal_log_prob(rng):
    x = rng.normal(size=(64,)) * 3
    loc = rng.normal(size=(64,))
    scale = rng.uniform(0.2, 3.0, size=(64,))
    got = port.Normal(_t(loc), _t(scale)).log_prob(_t(x))
    want = ref.Normal(_j(loc), _j(scale)).log_prob(_j(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_normal_scalar_params(rng):
    x = rng.normal(size=(10,))
    got = port.Normal(0.5, 2.0).log_prob(_t(x))
    want = ref.Normal(0.5, 2.0).log_prob(_j(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _mv_pair(form, rng, d):
    loc = rng.normal(size=(d,))
    if form == "scale":
        return (port.MvNormal(_t(loc), scale=0.7), ref.MvNormal(_j(loc), scale=0.7))
    if form == "scale_diag":
        s = rng.uniform(0.3, 2.0, size=(d,))
        return (port.MvNormal(_t(loc), scale_diag=_t(s)),
                ref.MvNormal(_j(loc), scale_diag=_j(s)))
    a = rng.normal(size=(d, d))
    cov = a @ a.T + d * np.eye(d)
    return (port.MvNormal.from_cov(_t(loc), _t(cov)),
            ref.MvNormal.from_cov(_j(loc), _j(cov)))


@pytest.mark.parametrize("form", ["scale", "scale_diag", "scale_tril"])
@pytest.mark.parametrize("batched", [False, True])
def test_mvnormal_log_prob(form, batched, rng):
    d = 3
    p, r = _mv_pair(form, rng, d)
    x = rng.normal(size=(32, d) if batched else (d,)) * 2
    got = p.log_prob(_t(x))
    want = r.log_prob(_j(x))
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_mvnormal_from_cov_factor(rng):
    a = rng.normal(size=(4, 4))
    cov = a @ a.T + np.eye(4)
    p = port.MvNormal.from_cov(torch.zeros(4), _t(cov))
    r = ref.MvNormal.from_cov(jnp.zeros(4), _j(cov))
    np.testing.assert_allclose(p.scale_tril.numpy(), np.asarray(r.scale_tril), atol=1e-5)


def test_mvnormal_standard():
    p = port.MvNormal.standard(3, device="cpu")
    assert p.dim == 3 and p.event_shape == (3,)
    x = np.array([0.1, -0.2, 0.3], np.float32)
    want = ref.MvNormal.standard(3).log_prob(_j(x))
    np.testing.assert_allclose(p.log_prob(_t(x)).numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("form", ["scale", "scale_diag", "scale_tril"])
def test_mvnormal_sample_moments(form, rng):
    """Draws from the explicit generator have the distribution's moments."""
    p, _ = _mv_pair(form, rng, 2)
    x = p.sample(generator(7, "cpu"), (200_000,))
    assert tuple(x.shape) == (200_000, 2)
    np.testing.assert_allclose(x.mean(0).numpy(), p.loc.numpy(), atol=0.02)
    if form == "scale_tril":
        cov = (p.scale_tril @ p.scale_tril.T).numpy()
        np.testing.assert_allclose(np.cov(x.numpy().T), cov, rtol=0.03, atol=0.02)


def test_sample_is_deterministic_in_the_generator_seed():
    d = port.Normal(0.0, 1.0)
    a = d.sample(generator(3, "cpu"), (5,))
    b = d.sample(generator(3, "cpu"), (5,))
    c = d.sample(generator(4, "cpu"), (5,))
    assert torch.equal(a, b) and not torch.equal(a, c)


# The rest of the univariate family, held against the JAX package's log_prob
# on shared inputs (atol 1e-5 relative to the magnitude; lgamma and log1p
# differ in their last ulps between the two libraries).
UNIVARIATE = {
    "LogNormal": (lambda m: m.LogNormal(0.3, 0.8), (-1.0, 6.0)),
    "Uniform": (lambda m: m.Uniform(-1.0, 2.5), (-2.0, 3.0)),
    "Exponential": (lambda m: m.Exponential(1.7), (-1.0, 5.0)),
    "Laplace": (lambda m: m.Laplace(0.5, 1.3), (-5.0, 5.0)),
    "Cauchy": (lambda m: m.Cauchy(-0.2, 0.7), (-8.0, 8.0)),
    "StudentT": (lambda m: m.StudentT(3.5, 0.4, 1.2), (-8.0, 8.0)),
    "TDist": (lambda m: m.TDist(5.0), (-8.0, 8.0)),
    "Gamma": (lambda m: m.Gamma(2.5, 1.5), (-1.0, 8.0)),
    "InverseGamma": (lambda m: m.InverseGamma(2.0, 3.0), (-1.0, 8.0)),
    "Beta": (lambda m: m.Beta(2.0, 3.5), (-0.2, 1.2)),
}


@pytest.mark.parametrize("name", sorted(UNIVARIATE))
def test_univariate_log_prob(name, rng):
    build, (lo, hi) = UNIVARIATE[name]
    x = np.concatenate([rng.uniform(lo, hi, size=200), [lo, hi]])
    got = build(port).log_prob(_t(x)).numpy()
    want = np.asarray(build(ref).log_prob(_j(x)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("name", ["InverseGamma", "Gamma", "Beta", "LogNormal"])
def test_univariate_tensor_params_broadcast(name, rng):
    """Parameters given as tensors carry a batch shape, as in JAX."""
    a = rng.uniform(1.5, 3.0, size=(5,))
    b = rng.uniform(0.5, 2.0, size=(5,))
    x = rng.uniform(0.1, 0.9, size=(4, 5))
    cls_p, cls_r = getattr(port, name), getattr(ref, name)
    got = cls_p(_t(a), _t(b)).log_prob(_t(x)).numpy()
    want = np.asarray(cls_r(_j(a), _j(b)).log_prob(_j(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)


# Sample moments of the new distributions from the explicit generator
# (200k draws; the tolerances are a few standard errors).
MOMENTS = {
    "LogNormal": (port.LogNormal(0.3, 0.5), np.exp(0.3 + 0.125), 0.01),
    "Uniform": (port.Uniform(-1.0, 2.5), 0.75, 0.01),
    "Exponential": (port.Exponential(2.0), 0.5, 0.005),
    "Laplace": (port.Laplace(0.5, 1.3), 0.5, 0.02),
    "StudentT": (port.StudentT(5.0, 0.4, 1.0), 0.4, 0.02),
    "Gamma": (port.Gamma(2.5, 1.5), 2.5 / 1.5, 0.01),
    "InverseGamma": (port.InverseGamma(4.0, 3.0), 1.0, 0.01),
    "Beta": (port.Beta(2.0, 3.5), 2.0 / 5.5, 0.005),
}


@pytest.mark.parametrize("name", sorted(MOMENTS))
def test_univariate_sample_mean(name):
    dist, mean, tol = MOMENTS[name]
    x = dist.sample(generator(11, "cpu"), (200_000,))
    assert tuple(x.shape) == (200_000,) and x.dtype == torch.float32
    assert abs(float(x.mean()) - mean) < tol


def test_cauchy_sample_median():
    x = port.Cauchy(-0.2, 0.7).sample(generator(5, "cpu"), (200_000,))
    assert abs(float(x.median()) + 0.2) < 0.02
