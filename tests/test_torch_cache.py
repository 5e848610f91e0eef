"""The megastep's discretization cache (``SolverConfig.cache_build``) in
the port against the JAX package's megastep kernel (Pallas, interpret mode
under ``jax.jit``), and the JAX package's own cache properties on the port.

Setup of the JAX package's tests/test_cache_and_ee.py: N=8, B=4, racetrack,
max_iter=15, rho_interval=0, constant reference 1.6. Tolerances of
tests/test_torch_megastep.py: u 2e-4, x 5e-4; the cached stage matrices
within 1e-5 of JAX's (their top blocks), the ages equal at every step (the
two took the same branch). The ``cuda`` test holds the cached kernel
against the plain version on the card (the megastep's 2e-4 / 5e-4) and
skips without one. JAX is imported inside the test that compares with it,
so the file runs on a machine with a card and no JAX:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cache.py -m cuda
"""

import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, SolverConfig, VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import constant_refs
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import (
    MegaCache, megacache_init, megastep, megastep_init, megastep_params, megastep_plain,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.megastep_kernel import _megacache_drift
from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import make_scenario_grid
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import racetrack

B = 4
_SCFG = SolverConfig(max_iter=15, rho_interval=0)
_KICK = [1.0, 0.2, 0.5, 0.3, 2.0, 0.2]


def _x0():
    x0 = np.tile(np.array([1.2, 0.0, 0.0, 0.0, 0.0, 0.05], np.float32)[None], (B, 1))
    x0[:, 4] = [0.3, 2.7, 6.1, 9.4]
    return x0


def _port_case(device="cpu"):
    p, cfg = VehicleParams(), MPCConfig(N=8, model="dynamic")
    track = racetrack(device=device)
    x0 = torch.tensor(_x0(), device=device)
    carry = megastep_init(p, cfg, track, x0)
    prm = megastep_params(p, B, device=device)
    return cfg, track, prm, constant_refs(cfg, 1.6, device=device), carry


def test_cached_megastep_matches_jax():
    """6 threaded steps of the cached megastep, the port's plain version
    against the JAX kernel: u, x, the stored stages and signature, and the
    age row (rebuilds and shifts at the same steps)."""
    import jax
    import jax.numpy as jnp

    from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
    from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
    from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
    from autonomous_racing_lpv_mpp_mpc_tpu.loop import constant_refs as jconstant_refs
    from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import megacache_init as jmegacache_init
    from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import megastep as jmegastep
    from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import megastep_init as jmegastep_init
    from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import megastep_params as jmegastep_params
    from autonomous_racing_lpv_mpp_mpc_tpu.track import racetrack as jrace

    jp, jcfg, jt = JVehicleParams(), JMPCConfig(N=8, model="dynamic"), jrace()
    jscfg = JSolverConfig(max_iter=15, rho_interval=0, cache_build=True)
    p_b = jax.tree.map(lambda l: jnp.broadcast_to(l, (B,) + jnp.shape(l)), jp)
    jprm = jmegastep_params(p_b, B)
    x_ref = jconstant_refs(jcfg, 1.6)
    step = jax.jit(lambda c, k: jmegastep(jcfg, jscfg, jt, jprm, x_ref, c, n_sub=4, interpret=True,
                                          cache=k))
    jc, jk = jmegastep_init(p_b, jcfg, jt, jnp.asarray(_x0())), jmegacache_init(jcfg, jscfg, B)

    cfg, scfg = convert.mpc_config(jcfg), convert.solver_config(jscfg)
    track = convert.track(jt, device="cpu")
    pc = megastep_init(convert.vehicle_params(p_b, device="cpu"), cfg, track, torch.tensor(_x0()))
    pk = megacache_init(cfg, scfg, B, device="cpu")
    prm = megastep_params(convert.vehicle_params(p_b, device="cpu"), B, device="cpu")
    xr = convert.tensor(x_ref, device="cpu")
    ages = []
    for _ in range(6):
        jc, ju, _, jk = step(jc, jk)
        pc, pu, _, pk = megastep(cfg, scfg, track, prm, xr, pc, n_sub=4, cache=pk)
        np.testing.assert_allclose(pu.numpy(), np.asarray(ju), atol=2e-4, rtol=0)
        np.testing.assert_allclose(pc.x.numpy(), np.asarray(jc.x), atol=5e-4, rtol=0)
        jn, pn = convert.to_numpy(convert.mega_cache(jk, device="cpu")), convert.to_numpy(pk)
        np.testing.assert_array_equal(pn["age"], jn["age"])
        for name in ("A", "B", "Xs", "Us", "kap"):
            np.testing.assert_allclose(pn[name], jn[name], atol=1e-5, rtol=0, err_msg=name)
        ages.append(float(pn["age"][0, 0]))
    assert 0.0 in ages[1:] and max(ages) > 0.0, ages     # both branches were taken


def _quality_case(case):
    """The JAX package's inputs of a witness case: (cfg, scfg, track, x_ref,
    per-lane params, x0). "jax_test": the JAX package's test setup above;
    "cell1_lanes": lanes 0-255 (128-lane groups 0 and 1) of main path 1's
    64 x 64 grid, N=20, the bench's solver settings."""
    import jax
    import jax.numpy as jnp

    from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
    from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
    from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
    from autonomous_racing_lpv_mpp_mpc_tpu.loop import constant_refs as jconstant_refs
    from autonomous_racing_lpv_mpp_mpc_tpu.parallel import make_scenario_grid as jgrid
    from autonomous_racing_lpv_mpp_mpc_tpu.track import racetrack as jrace

    if case == "jax_test":
        cfg = JMPCConfig(N=8, model="dynamic")
        p_b = jax.tree.map(lambda l: jnp.broadcast_to(l, (B,) + jnp.shape(l)), JVehicleParams())
        return (cfg, JSolverConfig(max_iter=15, rho_interval=0), jrace(), jconstant_refs(cfg, 1.6), p_b,
                jnp.asarray(_x0()))
    cfg = JMPCConfig(N=20, model="dynamic")
    scen = jgrid(JVehicleParams(), cfg, n_ey=64, n_mu=64, vx0=1.5)
    scfg = JSolverConfig(max_iter=20, rho_interval=0, early_exit=True, check_termination=2)
    return (cfg, scfg, jrace(), jconstant_refs(cfg, 1.8), jax.tree.map(lambda l: l[:256], scen.params),
            scen.x0[:256])


@pytest.mark.slow
@pytest.mark.parametrize("case", ["jax_test", "cell1_lanes"])
def test_cache_quality_matches_jax(case):
    """The cache's quality, a witness on the CPU: 40 steps of the uncached
    megastep threaded, the cached one forked from the same carry each step
    (the cache threaded along), in the JAX kernel (interpret mode) and in
    the port's plain version. The two take the same branch in every group
    at every step (equal ages), and each lane-step's |du| against its own
    uncached step agrees within the megastep's 2e-4. Prints the reuse
    share and the |du| distribution of both (run with -s);
    "cell1_lanes" is the slice that chip_smoke.py's [mega-cache] prints
    for the cached kernel on the card."""
    import jax

    from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import megacache_init as jmegacache_init
    from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import megastep as jmegastep
    from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import megastep_init as jmegastep_init
    from autonomous_racing_lpv_mpp_mpc_tpu.ops.megastep_kernel import megastep_params as jmegastep_params

    jcfg, jscfg0, jt, jxr, jp, jx0 = _quality_case(case)
    jscfg1, nb = jscfg0.replace(cache_build=True), jx0.shape[0]
    jprm = jmegastep_params(jp, nb)
    j0 = jax.jit(lambda c: jmegastep(jcfg, jscfg0, jt, jprm, jxr, c, n_sub=4, interpret=True))
    j1 = jax.jit(lambda c, k: jmegastep(jcfg, jscfg1, jt, jprm, jxr, c, n_sub=4, interpret=True, cache=k))
    jc, jk = jmegastep_init(jp, jcfg, jt, jx0), jmegacache_init(jcfg, jscfg1, nb)

    cfg, scfg0, scfg1 = (convert.mpc_config(jcfg), convert.solver_config(jscfg0),
                         convert.solver_config(jscfg1))
    track, xr = convert.track(jt, device="cpu"), convert.tensor(jxr, device="cpu")
    p = convert.vehicle_params(jp, device="cpu")
    prm = megastep_params(p, nb, device="cpu")
    pc = megastep_init(p, cfg, track, torch.tensor(np.asarray(jx0)))
    pk = megacache_init(cfg, scfg1, nb, device="cpu")
    du, reuse = {"jax": [], "port": []}, {"jax": [], "port": []}
    for _ in range(40):
        jn, ju0, _ = j0(jc)
        _, ju1, _, jk = j1(jc, jk)
        pn, pu0, _ = megastep(cfg, scfg0, track, prm, xr, pc, n_sub=4)
        _, pu1, _, pk = megastep(cfg, scfg1, track, prm, xr, pc, n_sub=4, cache=pk)
        jc, pc = jn, pn
        jage = convert.to_numpy(convert.mega_cache(jk, device="cpu"))["age"]
        np.testing.assert_array_equal(pk.age.numpy(), jage)
        du["jax"].append(np.abs(np.asarray(ju0) - np.asarray(ju1)).max(axis=0))
        du["port"].append((pu0 - pu1).abs().amax(dim=0).numpy())
        reuse["jax"].append((jage[0] > 0).mean())
        reuse["port"].append((pk.age[0] > 0).float().mean().item())
    for name in ("jax", "port"):
        d = np.asarray(du[name])
        print(f"[{case}] {name}: B={nb} N={cfg.N} reuse {np.mean(reuse[name]):.4f}, per lane-step |du| median "
              f"{np.median(d):.3e}, p95 {np.quantile(d, 0.95):.3e}, max {d.max():.3e}; per-step max |du| "
              f"median {np.median(d.max(axis=1)):.3e}")
    gap = np.abs(np.asarray(du["port"]) - np.asarray(du["jax"])).max()
    print(f"[{case}] max over lane-steps of |du_port - du_jax|: {gap:.3e}")
    assert gap <= 2e-4, gap


def test_cache_properties_on_the_port():
    """The JAX package's properties (test_cache_and_ee.py) on the port:
    (a) the first step, a rebuild forced by the saturated age, is bitwise
    the uncached step; (b) over 40 steps forked from the uncached carry the
    cache is reused and u stays within the documented band; (c) a kicked
    state trips the drift trigger."""
    cfg, track, prm, xr, car = _port_case()
    scfg1 = _SCFG.replace(cache_build=True)
    cache = megacache_init(cfg, scfg1, B, device="cpu")
    car_a, u_a, _ = megastep(cfg, _SCFG, track, prm, xr, car, n_sub=4)
    car_b, u_b, _, cache = megastep(cfg, scfg1, track, prm, xr, car, n_sub=4, cache=cache)
    assert torch.equal(u_a, u_b) and torch.equal(car_a.x, car_b.x)
    assert (cache.age == 0.0).all()

    car, reuse, dus = car_a, [], []
    for _ in range(40):
        car_a, u_a, _ = megastep(cfg, _SCFG, track, prm, xr, car, n_sub=4)
        _, u_b, _, cache = megastep(cfg, scfg1, track, prm, xr, car, n_sub=4, cache=cache)
        dus.append((u_a - u_b).abs().max().item())
        reuse.append(cache.age[0, 0].item() > 0)
        car = car_a
    assert np.mean(reuse) > 0.3, np.mean(reuse)
    assert max(dus) < 2e-2, max(dus)
    assert np.median(dus[10:]) < 5e-3, dus

    kick = car._replace(x=car.x + torch.tensor(_KICK)[:, None])
    assert (_megacache_drift(cfg, track, kick, cache) > scfg1.cache_drift_tol).all()
    _, _, _, cache2 = megastep(cfg, scfg1, track, prm, xr, kick, n_sub=4, cache=cache)
    assert (cache2.age == 0.0).all()


def test_cache_decision_per_128_lane_group():
    """At B=130 the decision is taken per 128-lane group: a kick to one car
    of group 0 rebuilds group 0 only, group 1 (lanes 128-129) keeps
    counting its age; lanes past B take no part."""
    p, cfg = VehicleParams(), MPCConfig(N=6)
    track = racetrack(device="cpu")
    scen = make_scenario_grid(p, cfg, n_ey=13, n_mu=10, vx0=1.3, device="cpu")
    scfg = SolverConfig(max_iter=10, rho_interval=0, cache_build=True)
    prm = megastep_params(scen.params, scen.batch, device="cpu")
    xr = constant_refs(cfg, 1.6, device="cpu")
    car = megastep_init(scen.params, cfg, track, scen.x0)
    cache = megacache_init(cfg, scfg, scen.batch, device="cpu")
    for _ in range(3):
        car, _, _, cache = megastep(cfg, scfg, track, prm, xr, car, n_sub=4, cache=cache)
    age = cache.age[0]
    assert (age[:128] == age[0]).all() and (age[128:] == age[128]).all()
    x = car.x.clone()
    x[:, 5] += torch.tensor(_KICK)
    _, _, _, kicked = megastep(cfg, scfg, track, prm, xr, car._replace(x=x), n_sub=4, cache=cache)
    _, _, _, free = megastep(cfg, scfg, track, prm, xr, car, n_sub=4, cache=cache)
    assert (kicked.age[0, :128] == 0.0).all()
    assert torch.equal(kicked.age[0, 128:], free.age[0, 128:])
    assert (free.age[0, 128:] > 0.0).all(), free.age[0, 128:]


def test_cache_shape_checks():
    """A cache of the wrong shape or a cache without cache_build raises."""
    cfg, track, prm, xr, car = _port_case()
    scfg1 = _SCFG.replace(cache_build=True)
    cache = megacache_init(cfg, scfg1, B, device="cpu")
    with pytest.raises(ValueError, match="cache.A has shape"):
        megastep(cfg, scfg1, track, prm, xr, car, cache=cache._replace(A=cache.A[:-1]))
    with pytest.raises(ValueError, match="needs scfg.cache_build"):
        megastep(cfg, _SCFG, track, prm, xr, car, cache=cache)
    assert isinstance(cache, MegaCache) and megastep.cached_launches == 0


def test_cuda_wrapper_operands(monkeypatch):
    """The wrapper's operands for the kernel, checked on the CPU with the
    launch replaced: the cache's twelve pointers follow the carry's (all
    null without a cache), then the section counters' (null),
    every operand is a contiguous float32 tensor
    even for a cache the plain version made (its stages are views), and
    the floats end with the drift tolerance, the ints with the age limit
    and the model."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import _cuda
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import megastep_kernel as mk

    calls = []
    monkeypatch.setattr(_cuda, "launch", lambda name, t, f, i, **kw: calls.append((t, f, i, kw)))
    monkeypatch.setattr(megastep, "cached_launches", 0)
    monkeypatch.setattr(megastep, "launches", 0)     # restored after: other files read the count
    cfg, track, prm, xr, car = _port_case()
    scfg1 = _SCFG.replace(cache_build=True, cache_drift_tol=0.25, cache_max_age=5)
    cache = megacache_init(cfg, scfg1, B, device="cpu")
    car, _, _, cache = megastep_plain(cfg, scfg1, track, prm, xr, car, n_sub=4, cache=cache)
    mk._megastep_cuda(cfg, _SCFG, track, prm, xr, car, 4, None, None, None)
    out = mk._megastep_cuda(cfg, scfg1, track, prm, xr, car, 4, None, None, cache)
    (t0, _, i0, kw0), (t1, f1, i1, kw1) = calls
    assert len(t0) == len(t1) == 32 and all(t is None for t in t0[20:])
    # no profiler records: the section counters' pointer is null, and a cached launch never has one
    assert kw0["counters"] == kw1["counters"] == (None,) and kw0["trace"] is kw1["trace"] is False
    assert all(t is not None and t.dtype == torch.float32 and t.is_contiguous() for t in t1[:11] + t1[12:])
    assert all(a is b for a, b in zip(t1[26:], out[3]))
    assert f1[-1] == pytest.approx(0.25) and i1[-2:] == [5, 0] and i0[-2] == _SCFG.cache_max_age
    assert megastep.cached_launches == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cached_kernel_matches_plain_on_card(cuda_device):
    """The cached kernel against the plain version, one step at a time from
    the plain version's carry and cache, over 12 steps (rebuilds and
    shifts): u 2e-4, x 5e-4, equal ages."""
    cfg, track, prm, xr, car = _port_case(cuda_device)
    scfg1 = _SCFG.replace(cache_build=True)
    cache = megacache_init(cfg, scfg1, B, device=cuda_device)
    before = megastep.cached_launches
    for _ in range(12):
        ck, uk, _, kk = megastep(cfg, scfg1, track, prm, xr, car, n_sub=4, cache=cache)
        car, up, _, cache = megastep_plain(cfg, scfg1, track, prm, xr, car, n_sub=4, cache=cache)
        torch.cuda.synchronize()
        assert (uk - up).abs().max().item() <= 2e-4
        assert (ck.x - car.x).abs().max().item() <= 5e-4
        assert torch.equal(kk.age, cache.age)
    assert megastep.cached_launches == before + 12
