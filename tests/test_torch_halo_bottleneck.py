"""Port parity of ``contrib/peer_memory`` (the 1-D halo exchange) and
``contrib/bottleneck`` (the spatially parallel bottleneck) against the
JAX package on the CPU.

The reference's ``test_halo_exchange.py`` and
``test_spatial_bottleneck.py`` cases at cp 2 and cp 4, in one spawn of
four gloo ranks (``tests/_torch_ranks.py``: cp 2 as two data-parallel
pairs, then cp 4), each rank running the port's function inside
``parallel_state.shard_map`` on its rows of H (the ``context`` axis):

- the exchange, halo 1 and 2, periodic and not, equals bit for bit the
  slices of the gathered array and the JAX ``halo_exchange_1d`` on a
  cp-device mesh;
- the gradient of each rank's local ``sum(y**2)`` returns every row's
  cotangent to its owner: the gradient of the gathered construction
  (the reference's 1e-6 relative and absolute), and the JAX function's
  gradient on the mesh;
- ``PeerHaloExchanger1d`` widens by ``2 * halo`` a rank; a halo of 0 or
  past the local extent raises the reference's ``ValueError``;
- the sharded bottleneck equals the unsharded one and the JAX
  package's, forward (1e-5 relative and absolute) and the gradient of x
  (1e-4), on the JAX ``init_spatial_bottleneck`` weights.

Inputs are the reference's ``jax.random`` draws, carried across as numpy.
This module imports no JAX at its top."""

import functools
import os

import numpy as np
import pytest
import torch

from _torch_ranks import spawn
from apex_tpu_torch.contrib.bottleneck import (
    spatial_bottleneck, spatial_parallel_bottleneck,
)
from apex_tpu_torch.contrib.peer_memory import (
    PeerHaloExchanger1d, halo_exchange_1d,
)
from apex_tpu_torch.transformer import parallel_state as ps

P = ps.PartitionSpec
ROWS = P(None, ps.CONTEXT_AXIS)
B, H_LOC, W, C = 2, 4, 5, 3          # the halo case: H = cp x 4
BB, BH, BW, BC, MID = 2, 16, 5, 8, 4  # the bottleneck case
CASES = [(h, per) for h in (1, 2) for per in (False, True)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the JAX side (memoized; imported lazily)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _halo_rig():
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "L0", "run_transformer",
                        "test_halo_exchange.py")
    spec = importlib.util.spec_from_file_location("_jax_halo_rig", path)
    rig = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rig)
    return rig


@functools.lru_cache(maxsize=None)
def _x(cp, seed):
    import jax
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (B, cp * H_LOC, W, C)))


@functools.lru_cache(maxsize=None)
def _bottleneck_inputs():
    import jax

    from apex_tpu.contrib.bottleneck import init_spatial_bottleneck
    key = jax.random.PRNGKey(0)
    params = init_spatial_bottleneck(jax.random.fold_in(key, 1), BC, MID)
    x = jax.random.normal(jax.random.fold_in(key, 2), (BB, BH, BW, BC))
    return {k: np.array(v) for k, v in params.items()}, np.array(x)


def _gathered(x, cp, halo, periodic):
    """The reference's per-rank expectation from the whole array."""
    rig = _halo_rig()
    rig.N, rig.H_LOC = cp, x.shape[1] // cp
    return np.asarray(rig.global_reference(x, halo, periodic))


def _jax_mesh(cp):
    import jax

    from apex_tpu.transformer import parallel_state as jps
    jps.initialize_model_parallel(context_parallel_size_=cp,
                                  devices=jax.devices()[:cp])
    return jps


@functools.lru_cache(maxsize=None)
def _jax_halo(cp):
    """The JAX exchange of every case and the gradient of the local
    sum(y**2) at halo 1, on a cp-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from apex_tpu.contrib.peer_memory import halo_exchange_1d as jhalo

    jps = _jax_mesh(cp)
    try:
        rows = JP(None, jps.CONTEXT_AXIS)

        def body(x0, x1):
            return tuple(jhalo(x0, h, axis=1, periodic=p)
                         for h, p in CASES) + (jax.grad(
                lambda x: jnp.sum(jhalo(x, 1, axis=1) ** 2,
                                  dtype=jnp.float32))(x1),)

        outs = jax.jit(jps.shard_map(body, in_specs=(rows, rows),
                                     out_specs=(rows,) * (len(CASES) + 1)))(
            _x(cp, 0), _x(cp, 1))
        out = {case: np.asarray(o) for case, o in zip(CASES, outs)}
        out["grad"] = np.asarray(outs[-1])
        return out
    finally:
        jps.destroy_model_parallel()


@functools.lru_cache(maxsize=None)
def _jax_bottleneck(cp):
    """The JAX block: unsharded forward and gradient of x, and the
    sharded forward and gradient on a cp-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from apex_tpu.contrib import bottleneck as jb

    params, x = _bottleneck_inputs()

    def fwd_dx(block):
        def run(p, x):
            y, vjp = jax.vjp(lambda x: block(p, x), x)
            return y, vjp(2.0 * y)[0]   # the gradient of sum(y**2)
        return run

    y, dx = jax.jit(fwd_dx(jb.spatial_bottleneck))(params, x)
    out = {"fwd": np.asarray(y), "dx": np.asarray(dx)}
    jps = _jax_mesh(cp)
    try:
        rows = JP(None, jps.CONTEXT_AXIS)
        y, dx = jax.jit(jps.shard_map(
            fwd_dx(jb.spatial_parallel_bottleneck), in_specs=(JP(), rows),
            out_specs=(rows, rows)))(params, x)
        out["sharded_fwd"], out["sharded_dx"] = np.asarray(y), np.asarray(dx)
        return out
    finally:
        jps.destroy_model_parallel()


# ---------------------------------------------------------------------------
# the port side, in each rank
# ---------------------------------------------------------------------------

def _grad_of(fn):
    """The gradient of this rank's local sum(fn(x)**2) w.r.t. its x."""
    def body(*args):
        x = args[-1].detach().requires_grad_(True)
        (fn(*args[:-1], x) ** 2).sum().backward()
        return x.grad
    return body


def _run(d):
    """Every case on this rank, under the installed mesh."""
    out = {}
    for halo, per in CASES:
        out[(halo, per)] = ps.shard_map(
            lambda x, h=halo, p=per: halo_exchange_1d(x, h, axis=1,
                                                      periodic=p),
            in_specs=ROWS, out_specs=ROWS)(d["x0"])
    out["grad"] = ps.shard_map(
        _grad_of(lambda x: halo_exchange_1d(x, 1, axis=1)),
        in_specs=ROWS, out_specs=ROWS)(d["x1"])
    out["wrapper"] = tuple(ps.shard_map(
        PeerHaloExchanger1d(halo=2), in_specs=ROWS,
        out_specs=ROWS)(torch.ones_like(d["x0"])).shape)
    errors = []
    for bad in (0, H_LOC + 1):
        try:
            ps.shard_map(lambda x, b=bad: halo_exchange_1d(x, b),
                         in_specs=ROWS, out_specs=ROWS)(d["x0"])
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    params, x = d["params"], d["bx"]
    out["fwd"] = ps.shard_map(spatial_parallel_bottleneck,
                              in_specs=(P(), ROWS),
                              out_specs=ROWS)(params, x)
    out["dx"] = ps.shard_map(_grad_of(spatial_parallel_bottleneck),
                             in_specs=(P(), ROWS), out_specs=ROWS)(params, x)
    return out


def job(rank, world, tmp):
    out = {}
    for cp in (2, 4):
        d = torch.load(os.path.join(tmp, f"inputs{cp}.pt"))
        ps.initialize_model_parallel(context_parallel_size_=cp,
                                     device="cpu")
        out[cp] = _run(d)
        ps.destroy_model_parallel()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("halo")
    params, bx = _bottleneck_inputs()
    for cp in (2, 4):
        torch.save({"x0": torch.from_numpy(np.array(_x(cp, 0))),
                    "x1": torch.from_numpy(np.array(_x(cp, 1))),
                    "params": {k: torch.from_numpy(v)
                               for k, v in params.items()},
                    "bx": torch.from_numpy(bx)},
                   os.path.join(tmp, f"inputs{cp}.pt"))
    return spawn(job, 4, tmp)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("halo,periodic", CASES)
def test_halo_matches_gathered_slices(halo, periodic, cp, ranks):
    want = _gathered(_x(cp, 0), cp, halo, periodic)
    want_j = _jax_halo(cp)[(halo, periodic)]
    np.testing.assert_array_equal(want_j, want)
    for r in (r[cp] for r in ranks):
        np.testing.assert_array_equal(r[(halo, periodic)].numpy(), want)


@pytest.mark.parametrize("cp", [2, 4])
def test_gradients_accumulate_back(cp, ranks):
    """Each row's cotangent returns to its owner: the gradient of the
    gathered construction's sum(y**2), and the JAX function's."""
    import jax
    import jax.numpy as jnp

    x = _x(cp, 1)
    rig = _halo_rig()
    rig.N, rig.H_LOC = cp, H_LOC
    want = np.asarray(jax.grad(lambda x: jnp.sum(
        rig.global_reference(x, 1, False) ** 2, dtype=jnp.float32))(x))
    for r in (r[cp] for r in ranks):
        np.testing.assert_allclose(r["grad"].numpy(), want, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(r["grad"].numpy(), _jax_halo(cp)["grad"],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cp", [2, 4])
def test_module_wrapper_and_validation(cp, ranks):
    for r in (r[cp] for r in ranks):
        assert r["wrapper"] == (B, cp * (H_LOC + 4), W, C)
        assert len(r["errors"]) == 2
        assert "halo must be positive" in r["errors"][0]
        assert "exceeds local extent" in r["errors"][1]


@pytest.mark.parametrize("cp", [2, 4])
def test_bottleneck_forward_matches_unsharded(cp, ranks):
    params, x = _bottleneck_inputs()
    want = spatial_bottleneck({k: torch.from_numpy(v)
                               for k, v in params.items()},
                              torch.from_numpy(x)).numpy()
    jx = _jax_bottleneck(cp)
    np.testing.assert_allclose(want, jx["fwd"], rtol=1e-5, atol=1e-5)
    for r in (r[cp] for r in ranks):
        got = r["fwd"].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, jx["fwd"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, jx["sharded_fwd"], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("cp", [2, 4])
def test_bottleneck_gradients_match_unsharded(cp, ranks):
    params, x = _bottleneck_inputs()
    xt = torch.from_numpy(x).requires_grad_(True)
    (spatial_bottleneck({k: torch.from_numpy(v) for k, v in params.items()},
                        xt) ** 2).sum().backward()
    want = xt.grad.numpy()
    jx = _jax_bottleneck(cp)
    np.testing.assert_allclose(want, jx["dx"], rtol=1e-4, atol=1e-4)
    for r in (r[cp] for r in ranks):
        got = r["dx"].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, jx["dx"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, jx["sharded_dx"], rtol=1e-4,
                                   atol=1e-4)
