"""The port's model and track remainders vs the JAX package's on the CPU:
``models.ltv_abc`` (exact Jacobians and the affine term), the second-order
Taylor discretization and its ``"order2"`` route, the ``"ltv"``
linearization route of ``engine.scheduled_stages`` and of the assembled QP,
and ``track.track_from_centerline``. Inputs are made from numpy seeds.

Tolerances: Jacobians, affine terms and the identity A x + B u + c = f at
the linearization point within 1e-6 of each array's largest entry (at
least 1e-6): forward-mode derivatives of the same float32 expressions
(tests/test_models.py holds the JAX identity to 1e-5 at entries of order
one; here the slow points make entries of order 100); discretized stages
the same; the centerline track exactly
(the same float64 host code, rounded once to float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCWeights as JMPCWeights
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.engine.assembly import build_boxqp as jbuild_boxqp
from autonomous_racing_lpv_mpp_mpc_tpu.engine.assembly import scheduled_stages as jscheduled_stages
from autonomous_racing_lpv_mpp_mpc_tpu.models import discretize as jdiscretize
from autonomous_racing_lpv_mpp_mpc_tpu.models import ltv_abc as jltv_abc
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval
from autonomous_racing_lpv_mpp_mpc_tpu.track import racetrack as jrace
from autonomous_racing_lpv_mpp_mpc_tpu.track import track_from_centerline as jtrack_from_centerline

from autonomous_racing_lpv_mpp_mpc_tpu_torch import convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.engine import build_boxqp, scheduled_stages
from autonomous_racing_lpv_mpp_mpc_tpu_torch.models import discretize, f_model, ltv_abc
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import track_from_centerline

CASES = [("dynamic", "linear"), ("dynamic", "pacejka"), ("kinematic", "linear")]


def _points(model, n, seed):
    rng = np.random.default_rng(seed)
    nx = 6 if model == "dynamic" else 4
    x = rng.uniform(0.2, 1.5, (n, nx)).astype(np.float32)
    x[:, 1 if model == "kinematic" else 3] = rng.uniform(-0.3, 0.3, n)       # e_psi
    x[:, -1] = rng.uniform(-0.3, 0.3, n)                                      # e_y
    u = rng.uniform(-0.2, 0.2, (n, 2)).astype(np.float32)
    kap = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    return x, u, kap


def _close(got, want, rel=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rel * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("model,tire", CASES)
def test_ltv_abc_matches_jax(model, tire):
    x, u, kap = _points(model, 16, seed=len(model) + len(tire))
    want = jax.jit(jax.vmap(lambda a, b, c: jltv_abc(JVehicleParams(), a, b, c, model, tire)))(x, u, kap)
    got = ltv_abc(VehicleParams(), torch.tensor(x), torch.tensor(u), torch.tensor(kap), model, tire)
    for g, w in zip(got, want):
        _close(g, w)
    # exact at the linearization point: A x + B u + c = f(x, u)
    A, B, c = got
    f0 = f_model(VehicleParams(), torch.tensor(x), torch.tensor(u), torch.tensor(kap), model, tire)
    lin = (A @ torch.tensor(x)[..., None])[..., 0] + (B @ torch.tensor(u)[..., None])[..., 0] + c
    _close(lin, f0.numpy())


@pytest.mark.parametrize("with_c", [False, True])
def test_discretize_order2_matches_jax(with_c):
    rng = np.random.default_rng(7)
    A = rng.normal(size=(5, 6, 6)).astype(np.float32)
    B = rng.normal(size=(5, 6, 2)).astype(np.float32)
    c = rng.normal(size=(5, 6)).astype(np.float32) if with_c else None
    want = jax.vmap(lambda a, b, *cc: jdiscretize(a, b, 1.0 / 30.0, *cc, method="order2"))(A, B, *([c] if with_c else []))
    got = discretize(torch.tensor(A), torch.tensor(B), 1.0 / 30.0, None if c is None else torch.tensor(c),
                     method="order2")
    assert len(got) == (3 if with_c else 2)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("model,disc", [("dynamic", "expm"), ("kinematic", "order2")])
def test_ltv_route_of_scheduled_stages_and_qp_matches_jax(model, disc):
    """``linearization="ltv"``: the stage matrices and the QP's affine
    dynamics term along a scheduled trajectory on the racetrack."""
    weights = JMPCWeights.for_model(model)
    jcfg = JMPCConfig(N=6, model=model, tire="pacejka" if model == "dynamic" else "linear",
                      linearization="ltv", discretization=disc, weights=weights)
    cfg = convert.mpc_config(jcfg)
    jt = jrace()
    t = convert.track(jt, device="cpu")
    X, U, _ = _points(model, 7, seed=11)
    X[:, 2 if model == "kinematic" else 4] = np.linspace(3.0, 3.4, 7)         # s along the track
    U = U[:6]
    want = jax.jit(lambda a, b: jscheduled_stages(JVehicleParams(), jcfg, jt, a, b))(jnp.asarray(X), jnp.asarray(U))
    got = scheduled_stages(VehicleParams(), cfg, t, torch.tensor(X)[None], torch.tensor(U)[None])
    assert float(np.abs(np.asarray(want[2])).max()) > 1e-3      # the affine term is there
    for g, w in zip(got, want):
        _close(g[0], w)
    x_ref = np.zeros((7, X.shape[1]), np.float32)
    x_ref[:, 0] = 1.5
    jqp = jax.jit(lambda a, b, r: jbuild_boxqp(JVehicleParams(), jcfg, jt, a[0], jnp.zeros(2), a, b, r))(
        jnp.asarray(X), jnp.asarray(U), jnp.asarray(x_ref))
    qp = build_boxqp(VehicleParams(), cfg, t, torch.tensor(X[:1]), torch.zeros(1, 2), torch.tensor(X)[None],
                     torch.tensor(U)[None], torch.tensor(x_ref))
    for name in ("A", "B", "c"):
        _close(getattr(qp.dyn, name)[0], getattr(jqp.dyn, name))


def test_track_from_centerline_matches_jax():
    """Recorded XY points of the oval and of the racetrack, subsampled and
    jittered, closed and open."""
    rng = np.random.default_rng(3)
    for jref, closed in ((joval(), True), (jrace(), True), (joval(), False)):
        xy = np.stack([np.asarray(jref.X), np.asarray(jref.Y)], axis=1)[::3].astype(np.float64)
        xy += rng.normal(0.0, 1e-3, xy.shape)
        want = jtrack_from_centerline(xy, width=0.8, ds=0.02, closed=closed)
        got = track_from_centerline(xy, width=0.8, ds=0.02, closed=closed, device="cpu")
        for name in ("ds", "length", "width", "kappa", "X", "Y", "psi"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    # the oval's corner curvature comes back (1/R = 1)
    k = got.kappa.numpy()
    assert abs(np.median(k[k > 0.5]) - 1.0) < 0.1
