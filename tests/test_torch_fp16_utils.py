"""Port parity: ``apex_tpu_torch.fp16_utils``, ``mlp``, ``fused_dense``
and ``transformer.amp.GradScaler`` against the JAX package, on the CPU.

The cases mirror ``tests/L0/run_fp16util/test_fp16_utils.py`` (:31-160)
and ``tests/L0/run_transformer/test_grad_scaler.py`` (:14, :31). The
GradScaler's cases run in two gloo ranks spawned with
``torch.multiprocessing`` (one thread each, meeting through a file in the
test's temporary directory): at ``tensor_model_parallel_size_=2`` one
rank overflows and both skip; at ``pipeline_model_parallel_size_=2``
likewise; over two data ranks (the tensor and pipeline axes of one rank,
skipped) each rank keeps its own found_inf; with no mesh, none is
reached. This module imports JAX only inside its tests, so the spawned
ranks do not.

Tolerances. The tree transforms are exact (casts). FP16_Optimizer's
step, with the same fp16 gradients on both sides, repeats the JAX
package's fp32 operations one at a time (the JAX side runs eagerly), so
masters, model params and the scaler state are held bit for bit; the
reference's trajectory against plain fp32 SGD is held to its own
limits (rtol 2e-2, atol 2e-3). The MLP and dense blocks in fp32 are
held within 1e-6 of the JAX package's (relative and absolute: the same
products, summed in other orders), their remat gradients bit for bit to
the plain ones."""

import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from apex_tpu_torch.fp16_utils import (
    FP16_Optimizer, FP16OptimizerState, master_params_to_model_params,
    model_grads_to_master_grads, network_to_half, prep_param_lists, tofp16,
)
from apex_tpu_torch.fused_dense import FusedDense, FusedDenseGeluDense
from apex_tpu_torch.mlp import MLP
from apex_tpu_torch.models._convert import params_from_jax
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.amp import GradScaler
from apex_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _port(tree):
    jax, _ = _jax()
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _by_path(tree, path=()):
    """{path: leaf}, dict keys sorted."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_by_path(tree[k], path + (k,)))
        return out
    return {path: tree}


def _equal_trees(got, want):
    """Port tree ``got`` against the JAX tree ``want``: the same paths,
    dtypes, shapes and bits."""
    g, w = _by_path(got), _by_path(_port(want))
    assert g.keys() == w.keys()
    for k in g:
        a, b = g[k], w[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), k


def make_params_np():
    rng = np.random.RandomState(0)
    return {"dense": {"kernel": rng.randn(16, 8).astype(np.float32),
                      "bias": np.zeros((8,), np.float32)},
            "layernorm": {"weight": np.ones((8,), np.float32),
                          "bias": np.zeros((8,), np.float32)},
            "step": np.int32(0)}


def test_network_to_half_keeps_norms_fp32():
    from apex_tpu.fp16_utils import network_to_half as jax_half
    from apex_tpu.fp16_utils import tofp16 as jax_tofp16

    jax, jnp = _jax()
    params = make_params_np()
    half = network_to_half(params_from_jax(params, "cpu"))
    assert half["dense"]["kernel"].dtype == torch.float16
    assert half["layernorm"]["weight"].dtype == torch.float32
    assert half["step"].dtype == torch.int32
    _equal_trees(half, jax_half(jax.tree.map(jnp.asarray, params)))
    _equal_trees(tofp16(params_from_jax(params, "cpu")),
                 jax_tofp16(jax.tree.map(jnp.asarray, params)))


def test_prep_and_roundtrip():
    from apex_tpu import fp16_utils as jfp

    jax, jnp = _jax()
    params = make_params_np()
    model = network_to_half(params_from_jax(params, "cpu"))
    model_p, master = prep_param_lists(model)
    assert model_p is model
    assert master["dense"]["kernel"].dtype == torch.float32
    jmodel = jfp.network_to_half(jax.tree.map(jnp.asarray, params))
    _, jmaster = jfp.prep_param_lists(jmodel)
    _equal_trees(master, jmaster)
    back = master_params_to_model_params(model_p, master)
    assert back["dense"]["kernel"].dtype == torch.float16
    _equal_trees(back, jfp.master_params_to_model_params(jmodel, jmaster))
    g16 = tree_map(lambda a: a.half() if a.is_floating_point() else a,
                   params_from_jax(params, "cpu"))
    g = model_grads_to_master_grads(g16)
    assert g["dense"]["kernel"].dtype == torch.float32
    assert g["step"].dtype == torch.int32


def _sgd_problem():
    rng = np.random.RandomState(1)
    w = rng.randn(32, 4).astype(np.float32)
    x = rng.randn(8, 32).astype(np.float32)
    return w, x


def test_fp16_optimizer_matches_fp32_sgd():
    """Static scale 128: the scaled-loss fp16 gradients through
    FP16_Optimizer track plain fp32 SGD (the reference's limits)."""
    w, x = _sgd_problem()
    tx = torch.from_numpy(x)

    def loss_fn(p, dtype):
        return (((tx.to(dtype) @ p["w"].to(dtype)).float()) ** 2).sum()

    opt = FP16_Optimizer(FusedSGD(lr=1e-3), static_loss_scale=128.0)
    model16 = {"w": torch.from_numpy(w).half()}
    st = opt.init(model16)
    ref = FusedSGD(lr=1e-3)
    ref_p = {"w": torch.from_numpy(w)}
    ref_st = ref.init(ref_p)
    for _ in range(3):
        p = {"w": model16["w"].detach().requires_grad_(True)}
        (g,) = torch.autograd.grad(opt.scale_loss(loss_fn(p, torch.float16),
                                                  st), [p["w"]])
        assert g.dtype == torch.float16
        model16, st = opt.step({"w": g}, model16, st)
        rp = {"w": ref_p["w"].detach().requires_grad_(True)}
        (rg,) = torch.autograd.grad(loss_fn(rp, torch.float32), [rp["w"]])
        ref_p, ref_st = ref.step({"w": rg}, ref_p, ref_st)
    np.testing.assert_allclose(st.master["w"].numpy(), ref_p["w"].numpy(),
                               rtol=2e-2, atol=2e-3)
    assert model16["w"].dtype == torch.float16


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_fp16_optimizer_step_matches_jax_bitwise(dynamic):
    """Three steps on the same fp16 gradients (the third an overflow)
    through the JAX and the port FP16_Optimizer over FusedSGD with
    momentum: masters, model params and scaler state bit for bit."""
    from apex_tpu.fp16_utils import FP16_Optimizer as JaxFP16
    from apex_tpu.optimizers import FusedSGD as JaxSGD

    jax, jnp = _jax()
    w, _ = _sgd_problem()
    rng = np.random.RandomState(2)
    grads = [(rng.randn(32, 4) * 64).astype(np.float16) for _ in range(3)]
    grads[2][0, 0] = np.inf
    kw = dict(dynamic_loss_scale=True) if dynamic else \
        dict(static_loss_scale=128.0)
    jopt = JaxFP16(JaxSGD(lr=1e-3, momentum=0.9), **kw)
    popt = FP16_Optimizer(FusedSGD(lr=1e-3, momentum=0.9), **kw)
    jm = {"w": jnp.asarray(w).astype(jnp.float16)}
    pm = {"w": torch.from_numpy(w).half()}
    jst, pst = jopt.init(jm), popt.init(pm)
    for g in grads:
        jm, jst = jopt.step({"w": jnp.asarray(g)}, jm, jst)
        pm, pst = popt.step({"w": torch.from_numpy(g)}, pm, pst)
        _equal_trees(pm, jm)
        _equal_trees(pst.master, jst.master)
        _equal_trees(pst.inner.momentum_buf, jst.inner.momentum_buf)
        assert float(popt.loss_scale(pst)) == float(jopt.loss_scale(jst))
        assert int(pst.scaler.overflows) == int(jst.scaler.overflows)
    assert int(pst.scaler.overflows) == (1 if dynamic else 0)


@pytest.mark.parametrize("flat", [False, True], ids=["tree", "flat"])
def test_fp16_optimizer_dynamic_overflow_skips_and_halves(flat):
    """The reference's case (FusedAdam), and the flat FusedSGD the
    card's ``fp16_optimizer`` phase runs: an inf gradient skips the step
    (model params and masters bit for bit) and halves the scale; a
    clean one moves the params."""
    inner = FusedSGD(lr=1e-2, momentum=0.9, use_flat_kernel=True) if flat \
        else FusedAdam(lr=1e-2)
    model16 = {"w": torch.ones((4, 4), dtype=torch.float16),
               "b": torch.zeros(3, dtype=torch.float16)}
    opt = FP16_Optimizer(inner, dynamic_loss_scale=True)
    st = opt.init(model16)
    s0 = float(opt.loss_scale(st))
    bad = {"w": torch.full((4, 4), float("inf"), dtype=torch.float16),
           "b": torch.ones(3, dtype=torch.float16)}
    new_model, st2 = opt.step(bad, model16, st)
    assert float(opt.loss_scale(st2)) == s0 / 2
    for a, b in zip(tree_leaves(new_model) + tree_leaves(st2.master),
                    tree_leaves(model16) + tree_leaves(st.master)):
        assert torch.equal(a, b)
    good = {"w": torch.full((4, 4), 0.1, dtype=torch.float16),
            "b": torch.full((3,), 0.1, dtype=torch.float16)}
    new_model, st3 = opt.step(good, model16, st2)
    assert float((st3.master["w"] - st2.master["w"]).abs().max()) > 0
    if not flat:   # Adam moves by about lr, past an fp16 ulp of 1
        assert float((new_model["w"] - model16["w"]).abs().max()) > 0


def test_fp16_optimizer_state_dict_roundtrip():
    model16 = {"w": torch.ones((4, 4), dtype=torch.float16)}
    opt = FP16_Optimizer(FusedAdam(lr=1e-2), dynamic_loss_scale=True)
    st = opt.init(model16)
    st2 = opt.load_state_dict(opt.state_dict(st))
    assert isinstance(st2, FP16OptimizerState)
    for a, b in zip(tree_leaves((st.master, st.inner)),
                    tree_leaves((st2.master, st2.inner))):
        assert torch.equal(a, b)
    for f in ("loss_scale", "unskipped", "overflows"):
        assert torch.equal(getattr(st.scaler, f), getattr(st2.scaler, f))


# -- mlp / fused_dense -------------------------------------------------------

def _x(shape=(4, 16), seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("activation", ["relu", "sigmoid", "none"])
def test_mlp_matches_jax(activation):
    from apex_tpu.mlp import MLP as JaxMLP

    jax, jnp = _jax()
    jm = JaxMLP([16, 32, 8], activation=activation)
    params = jm.init(jax.random.PRNGKey(0))
    x = _x()
    pm = MLP([16, 32, 8], activation=activation)
    _close(pm.apply(_port(params), torch.from_numpy(x)),
           jm.apply(params, jnp.asarray(x)))


def test_mlp_init_draws_the_reference_distribution():
    layers = MLP([64, 32, 8], bias=False).init(
        torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(p["kernel"].shape) for p in layers] == [(64, 32), (32, 8)]
    assert all(set(p) == {"kernel"} for p in layers)
    k = layers[0]["kernel"]
    assert float(k.abs().max()) <= 1 / 8 and float(k.std()) > 0.06


def test_mlp_remat_same_values_and_grads():
    mlp, mlp_r = MLP([16, 32, 8]), MLP([16, 32, 8], remat=True)
    params = mlp.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(_x())

    def grads(m):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        it = iter(leaves)
        p = tree_map(lambda _: next(it), params)
        return torch.autograd.grad((m.apply(p, x) ** 2).sum(), leaves)

    for a, b in zip(grads(mlp), grads(mlp_r)):
        assert torch.equal(a, b)


def test_mlp_validation():
    with pytest.raises(ValueError):
        MLP([16])
    with pytest.raises(ValueError):
        MLP([16, 8], activation="tanh")
    assert MLP([16, 8], relu=False).activation == "none"


def test_fused_dense_matches_jax():
    from apex_tpu.fused_dense import FusedDense as JaxFD

    jax, jnp = _jax()
    params = JaxFD(16, 8).init(jax.random.PRNGKey(0))
    x = _x()
    _close(FusedDense(16, 8).apply(_port(params), torch.from_numpy(x)),
           JaxFD(16, 8).apply(params, jnp.asarray(x)))


def test_fused_dense_gelu_dense_matches_jax():
    """The exact (erf) GELU between the two products."""
    from apex_tpu.fused_dense import FusedDenseGeluDense as JaxFDG

    jax, jnp = _jax()
    params = JaxFDG(16, 32, 8).init(jax.random.PRNGKey(0))
    x = _x()
    _close(FusedDenseGeluDense(16, 32, 8).apply(_port(params),
                                                torch.from_numpy(x)),
           JaxFDG(16, 32, 8).apply(params, jnp.asarray(x)))
    p = FusedDenseGeluDense(16, 32, 8, bias=False).init(
        torch.Generator().manual_seed(0), device="cpu")
    assert set(p) == {"fc1", "fc2"} and set(p["fc1"]) == {"kernel"}


def test_autocast_flows_through_mlp_and_fused_dense():
    from apex_tpu_torch.amp import autocast

    gen = torch.Generator().manual_seed(0)
    mlp, fd = MLP([16, 8]), FusedDense(16, 8)
    fdg = FusedDenseGeluDense(16, 32, 8)
    pm, pf, pg = (m.init(gen, device="cpu") for m in (mlp, fd, fdg))
    x = torch.ones((2, 16))
    with autocast(torch.bfloat16):
        assert mlp.apply(pm, x).dtype == torch.bfloat16
        assert fd.apply(pf, x).dtype == torch.bfloat16
        assert fdg.apply(pg, x).dtype == torch.bfloat16
    assert mlp.apply(pm, x).dtype == torch.float32


# -- GradScaler over two gloo ranks ------------------------------------------

LAYOUTS = {"tp2": dict(tensor_model_parallel_size_=2),
           "pp2": dict(pipeline_model_parallel_size_=2),
           "dp2": {}, "no_mesh": None}


def _scaler_rank(rank, tmp):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'pg')}", rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=60))
    out = {}
    try:
        for name, kw in LAYOUTS.items():
            if kw is not None:
                ps.initialize_model_parallel(device="cpu", **kw)
            scaler = GradScaler()
            state = scaler.init_state("cpu")
            g = torch.ones(4)
            if rank == 1:
                g[0] = float("inf")
            grads, found = scaler.unscale({"g": g}, state)
            out[name] = (bool(found), grads["g"])
            ps.destroy_model_parallel()
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_grad_scaler_ors_found_inf_over_model_parallel_groups(tmp_path):
    ctx = mp.spawn(_scaler_rank, args=(str(tmp_path),), nprocs=2,
                   join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("GradScaler ranks did not finish in 120 s")
    res = [torch.load(os.path.join(tmp_path, f"rank{r}.pt"))
           for r in range(2)]
    want = {"tp2": [True, True], "pp2": [True, True],
            "dp2": [False, True], "no_mesh": [False, True]}
    assert {n: [r[n][0] for r in res] for n in LAYOUTS} == want
    for r, out in enumerate(res):
        for name in LAYOUTS:
            g = out[name][1]
            assert torch.equal(g[1:], torch.full((3,), 2.0 ** -16))


def test_grad_scaler_without_a_mesh_is_the_loss_scaler():
    """No mesh (the unbound axes): the LossScaler's unscale as it is."""
    from apex_tpu_torch.amp import LossScaler

    ps.destroy_model_parallel()
    g = {"a": torch.tensor([1.0, float("nan")]), "b": torch.ones(3)}
    gs, fs = GradScaler(), LossScaler()
    got, found = gs.unscale(g, gs.init_state("cpu"))
    want, wfound = fs.unscale(g, fs.init_state("cpu"))
    assert bool(found) and bool(wfound)
    assert torch.equal(got["b"], want["b"])
