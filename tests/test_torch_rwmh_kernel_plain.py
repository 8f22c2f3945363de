"""The plain versions of the CUDA RWMH kernels (ops/rwmh.py) and the whole
RWMH slice on CPU tensors.

The fused wrappers run their plain version for CPU tensors, so
``sample(engine="fused")`` here exercises everything around the kernels:
the Philox stream, the step, the schedule, the transposes and the bundle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
import advancedmh_tpu_torch as port
from advancedmh_tpu.models.targets import gaussian_mean_scale_model as ref_model
from advancedmh_tpu_torch.convert import gaussian_mean_scale_from_numpy
from advancedmh_tpu_torch.ops import (
    fused_rwmh,
    fused_rwmh_sample,
    philox4x32_reference,
    rwmh_reference,
    rwmh_sample_reference,
    step_noise,
    uniform_from_bits,
)

DATA = np.random.default_rng(1234).normal(size=30)
MODEL = gaussian_mean_scale_from_numpy(DATA, device="cpu")
SCALES = {"diag": 0.35, "tril": [[0.35, 0.0], [0.1, 0.3]]}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's threads in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for philox4x32-10."""
    got = philox4x32_reference(torch.tensor([counter], dtype=torch.int64), key)
    assert tuple(int(v) for v in got[0]) == want


def test_uniforms_strictly_inside_unit_interval():
    edge = uniform_from_bits(torch.tensor([0, 0x7FFFFF, 0xFFFFFFFF, 0x80000000]))
    assert bool(((edge > 0) & (edge < 1)).all())
    z, logu = step_noise(123, 1, 200, 512, 2, "cpu")
    assert bool((logu < 0).all()) and bool(torch.isfinite(logu).all())
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01


def test_noise_depends_only_on_seed_step_and_chain():
    z_a, u_a = step_noise(9, 1, 10, 8, 2, "cpu")
    z_b, u_b = step_noise(9, 5, 3, 4, 2, "cpu")
    assert torch.equal(z_a[4:7, :, :4], z_b) and torch.equal(u_a[4:7, :4], u_b)
    z_c, _ = step_noise(10, 1, 10, 8, 2, "cpu")
    assert not torch.equal(z_a, z_c)


@pytest.mark.parametrize("d", [1, 3, 5])
def test_noise_any_dimension(d):
    z, logu = step_noise(1, 1, 4, 6, d, "cpu")
    assert tuple(z.shape) == (4, d, 6) and tuple(logu.shape) == (4, 6)


def _start(C, seed=0):
    rng = np.random.default_rng(seed)
    p = torch.tensor(np.stack([rng.normal(size=C), rng.uniform(-0.5, 2.0, size=C)]),
                     dtype=torch.float32)
    return p, MODEL.tile_density(p, *MODEL.tile_consts)


def _args(p, lp, scale, seed=77):
    return (MODEL.tile_density, MODEL.cuda_density, p, lp, scale, MODEL.tile_consts, seed)


@pytest.mark.parametrize("form", ["diag", "tril"])
@pytest.mark.parametrize("burn,thin,n", [(0, 1, 9), (5, 3, 7), (4, 1, 6)])
def test_schedule_identity(form, burn, thin, n):
    """Sample k of the sampling kernel is the throughput kernel run for
    burn + (k+1)·thin steps: exact, because the noise is counter-based."""
    p, lp = _start(37)
    s, l, a = rwmh_sample_reference(*_args(p, lp, SCALES[form]), burn=burn, thin=thin,
                                    n_samples=n, iteration_offset=3)
    for k in (0, n // 2, n - 1):
        pk, lk, _ = rwmh_reference(*_args(p, lp, SCALES[form]),
                                   n_steps=burn + (k + 1) * thin, iteration_offset=3)
        assert torch.equal(s[k], pk) and torch.equal(l[k], lk)


def test_accept_rule_at_the_support_edge():
    """accept iff log(u) < lp_cand − lp: a −inf start accepts any finite
    candidate, a −inf candidate is rejected, and so is −inf → −inf (NaN)."""
    from advancedmh_tpu_torch.ops.common import scale_block
    from advancedmh_tpu_torch.ops.rwmh import rwmh_step

    x = torch.tensor([[0.0, 0.0, 0.0], [-0.5, -0.5, 1.0]])
    lp = MODEL.tile_density(x, *MODEL.tile_consts)
    z = torch.tensor([[0.0, 0.0, 0.0], [4.0, 0.5, -8.0]])  # σ → 1.5, 0.0, -1.0
    logu = torch.full((3,), -1e-6)
    scale, tril = scale_block(0.25, 2, "cpu")
    x1, lp1, acc = rwmh_step(x, lp, z, logu, scale, tril, MODEL.tile_density,
                             MODEL.tile_consts)
    assert acc[0].tolist() == [True, False, False]
    assert torch.isfinite(lp1[0, 0]) and torch.isneginf(lp1[0, 1])
    assert torch.equal(x1[:, 2], x[:, 2])


def test_odd_step_counts():
    p, lp = _start(50, seed=3)
    for n_steps in (1, 7):
        x, l, acc = rwmh_reference(*_args(p, lp, 0.35), n_steps=n_steps)
        assert bool((acc >= 0).all() & (acc <= n_steps).all())
    assert bool((x[1][torch.isfinite(l[0])] >= 0).all())


def test_wrappers_on_cpu_run_the_plain_version():
    fused_rwmh_sample.launches = fused_rwmh.launches = 0
    p, lp = _start(16)
    got = fused_rwmh_sample(*_args(p, lp, 0.35), burn=2, thin=2, n_samples=5)
    want = rwmh_sample_reference(*_args(p, lp, 0.35), burn=2, thin=2, n_samples=5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = fused_rwmh(*_args(p, lp, 0.35), n_steps=5)
    want = rwmh_reference(*_args(p, lp, 0.35), n_steps=5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fused_rwmh_sample.launches == 0 and fused_rwmh.launches == 0


def test_grid_quadrature_reference():
    """The float64 quadrature chip_smoke.py checks against, on CPU."""
    import chip_smoke

    mu, sig = chip_smoke.grid_posterior_means(DATA.astype(np.float32))
    assert abs(mu - DATA.mean()) < 1e-3
    assert 0.9 * DATA.std() < sig < 1.3 * DATA.std()


def test_fused_slice_matches_jax_and_quadrature():
    """sample(engine="fused") on CPU tensors (the plain version) against JAX
    sample(engine="xla") and the grid quadrature, within 0.05."""
    import chip_smoke

    spl = port.RWMH(port.MvNormal(torch.zeros(2), scale=0.35))
    c = port.sample(MODEL, spl, 1500, num_chains=1024, engine="fused",
                    discard_initial=500, initial_params=[0.0, 1.0], key=11,
                    chain_type="chains", param_names=["μ", "σ"])
    assert c.values.shape == (1500, 2, 1024) and c.range == range(501, 2001)
    r = ref.sample(ref_model(data=DATA), ref.RWMH(ref.MvNormal(jnp.zeros(2), scale=0.35)),
                   1000, key=11, num_chains=512, discard_initial=500,
                   initial_params=jnp.asarray([0.0, 1.0]), chain_type="chains",
                   param_names=["μ", "σ"])
    mu_q, sig_q = chip_smoke.grid_posterior_means(DATA.astype(np.float32))
    s = c.summary()
    for name, q in (("μ", mu_q), ("σ", sig_q)):
        assert abs(s[name]["mean"] - float(r.mean(name))) < 0.05
        assert abs(s[name]["mean"] - q) < 0.05
        assert s[name]["rhat"] < 1.01


# ---- the flagship's group form (csrc/rwmh.cu::RwmhGroup) ----------------------
#
# The kernels sum the flagship's observations over a group of lanes; the plain
# versions keep the ordered tile density. These tests hold the group's order
# to float64 and show that it only moves lp's last bits.

def _lanes_density(p, obs, lanes):
    """The flagship's tile density (``p`` (2, C), ``obs`` (n, 1)) with the
    observations summed as a group of ``lanes`` lanes (a power of 2) sums
    them in csrc/rwmh.cu::RwmhGroup: partial l adds the terms (w z_i) z_i
    of observations l, l + lanes, .. in order from +0, w = -0.5, and the
    partials combine pairwise, ((p0 + p1) + (p2 + p3)) at 4 lanes. Slots
    past the last observation hold 0 with w = 0: their term +-0 changes no
    partial."""
    n = obs.shape[0]
    mu, sigma = p[0:1], p[1:2]
    inv = 1.0 / torch.clamp(sigma, min=0.1)
    rounds = -(-n // lanes)
    pad = rounds * lanes - n
    obs = torch.cat([obs, obs.new_zeros(pad, 1)])
    w = torch.cat([obs.new_full((n, 1), -0.5), obs.new_zeros(pad, 1)])
    z = (obs - mu) * inv
    t = (w * z * z).view(rounds, lanes, -1)
    part = torch.zeros_like(t[0])
    for row in t:
        part = part + row
    while part.shape[0] > 1:
        part = part[0::2] + part[1::2]
    lp = part + n * torch.log(inv) - n * 0.5 * np.log(2.0 * np.pi)
    return torch.where(sigma >= 0, lp, torch.full_like(lp, -torch.inf))


def _by_hand_lanes(p, obs, lanes):
    """The group form's lp of each chain in numpy float32 scalars: partial l
    adds observations l, l + lanes, .. in order from +0, the partials
    combine pairwise, then (sum + n log inv) - n log(2 pi)/2."""
    f = np.float32
    obs = obs.numpy().ravel().astype(f)
    n = obs.size
    out = []
    for mu, sigma in p.numpy().T.astype(f):
        inv = f(1.0) / max(sigma, f(0.1))
        part = [f(0.0)] * lanes
        for i in range(n):
            z = (obs[i] - mu) * inv
            part[i % lanes] = part[i % lanes] + f(-0.5) * z * z
        while len(part) > 1:
            part = [part[k] + part[k + 1] for k in range(0, len(part), 2)]
        log_inv = f(torch.log(torch.tensor(inv)))  # torch's logf, not numpy's
        lp = (part[0] + f(n) * log_inv) - f(n * 0.5 * np.log(2.0 * np.pi))
        out.append(lp if sigma >= 0 else -np.inf)
    return np.array(out, dtype=f)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("n_obs", [30, 32, 7])
def test_group_density_sums_in_the_lanes_order(lanes, n_obs):
    """The group's order is the by-hand float32 sum of the same partials in
    the same tree, bit for bit, and within 1e-6 relative of the float64
    density."""
    obs = torch.tensor(np.random.default_rng(n_obs).normal(size=n_obs),
                       dtype=torch.float32).reshape(-1, 1)
    p, _ = _start(64, seed=n_obs)
    got = _lanes_density(p, obs, lanes)[0]
    want = torch.from_numpy(_by_hand_lanes(p, obs, lanes))
    inside = p[1] >= 0
    assert torch.equal(torch.isneginf(got), ~inside)
    assert torch.equal(got[inside], want[inside])
    p64, obs64 = p.double(), obs.double()
    inv = 1.0 / torch.clamp(p64[1], min=0.1)
    lp64 = (-0.5 * ((obs64 - p64[0]) * inv) ** 2).sum(0) + n_obs * torch.log(inv) \
        - n_obs * 0.5 * np.log(2.0 * np.pi)
    rel = ((got.double() - lp64).abs() / lp64.abs())[inside]
    assert float(rel.max()) < 1e-6


@pytest.mark.parametrize("lanes", [2, 4, 8])
@pytest.mark.parametrize("base", [17, (1 << 32) - 3])
def test_lane_draws_its_steps_noise(lanes, base):
    """Lane l of a group draws step base + l's noise from the counter (low
    word of base + l, chain, 0, high word): the words step_noise reads, so
    the noise drawn ahead is the noise of that step (across the counter's
    32-bit carry too)."""
    from advancedmh_tpu_torch.ops.common import box_muller

    seed, C = 0x1234_5678_9ABC, 6
    for lane in range(lanes):
        j = base + lane
        c = torch.arange(C, dtype=torch.int64)
        counter = torch.stack([torch.full_like(c, j & 0xFFFFFFFF), c, torch.zeros_like(c),
                               torch.full_like(c, j >> 32)], dim=-1)
        u = uniform_from_bits(philox4x32_reference(counter, (seed & 0xFFFFFFFF, seed >> 32)))
        z, logu = step_noise(seed, j, 1, C, 2, "cpu")
        assert torch.equal(box_muller(u[None, :, :2], 2), z)
        assert torch.equal(torch.log(u[:, 2]), logu[0])


@pytest.mark.parametrize("reference", ["sample", "steps"])
def test_group_order_takes_the_plain_decisions(reference):
    """The plain versions run on the group's order of the flagship's sum
    take the same decisions as on the ordered tile density they keep, with
    lp within float32 rounding of it: the group form changes lp's last bits
    only."""
    def group(x, obs):
        return _lanes_density(x, obs, 2)

    p, lp = _start(256, seed=8)
    args = (MODEL.tile_density, MODEL.cuda_density, p, lp, 0.35, MODEL.tile_consts, 5)
    grouped = (group, *args[1:])
    if reference == "sample":
        kw = dict(burn=3, thin=2, n_samples=6)
        (s, l, a), (s_g, l_g, a_g) = (rwmh_sample_reference(*args, **kw),
                                      rwmh_sample_reference(*grouped, **kw))
    else:
        (s, l, a), (s_g, l_g, a_g) = (rwmh_reference(*args, n_steps=9),
                                      rwmh_reference(*grouped, n_steps=9))
    assert torch.equal(a, a_g) and torch.equal(s, s_g)
    fin = torch.isfinite(l)
    assert torch.equal(fin, torch.isfinite(l_g))
    assert torch.allclose(l_g[fin], l[fin], rtol=1e-6, atol=1e-6)
