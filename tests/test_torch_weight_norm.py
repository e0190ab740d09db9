"""Port parity of ``reparameterization/weight_norm.py`` against the JAX
package on the CPU, the reference's
``tests/L0/run_rnn/test_weight_norm.py`` cases, each also held to the
JAX functions on the same ``jax.random`` weights (carried across as
numpy): the split reconstructs w (1e-6 relative) and g is JAX's; the
direction invariance under scaling v (1e-5); the gradients through
``compute_weight`` equal ``jax.grad``'s and the autograd of the
definition (1e-5 relative, 1e-6 absolute); an fp16 v whose sum of
squares overflows fp16 keeps finite, fp16 weights, JAX's bits. This
module imports no JAX at its top."""

import numpy as np
import torch

from apex_tpu_torch.reparameterization import (
    apply_weight_norm, compute_weight, remove_weight_norm,
)


def _normal(seed, shape):
    import jax
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape))


def test_split_reconstructs_identity():
    from apex_tpu import reparameterization as jwn

    w = _normal(0, (8, 16))
    g, v = apply_weight_norm(torch.from_numpy(w), dim=0)
    assert g.shape == (8, 1)
    np.testing.assert_allclose(g.numpy(),
                               np.asarray(jwn.apply_weight_norm(w, 0)[0]),
                               rtol=1e-6)
    np.testing.assert_allclose(compute_weight(g, v, 0).numpy(), w,
                               rtol=1e-6)
    np.testing.assert_allclose(remove_weight_norm(g, v, 0).numpy(), w,
                               rtol=1e-6)
    # the other axis, and a 1-D v (the norm of each element, as JAX's)
    for x, dim in ((w, 1), (w[0], 0)):
        g1, v1 = apply_weight_norm(torch.from_numpy(x), dim)
        jg, jv = jwn.apply_weight_norm(x, dim)
        np.testing.assert_allclose(g1.numpy(), np.asarray(jg), rtol=1e-6)
        np.testing.assert_allclose(
            compute_weight(g1, v1, dim).numpy(),
            np.asarray(jwn.compute_weight(jg, jv, dim)), rtol=1e-6)


def test_direction_invariance():
    """Scaling v leaves w unchanged (the reparameterization's point)."""
    w = torch.from_numpy(_normal(1, (4, 6)))
    g, v = apply_weight_norm(w)
    np.testing.assert_allclose(compute_weight(g, 7.5 * v).numpy(),
                               compute_weight(g, v).numpy(), rtol=1e-5)


def test_gradients_match_autodiff_of_definition():
    import jax
    import jax.numpy as jnp

    from apex_tpu import reparameterization as jwn

    w0 = _normal(2, (4, 6))
    g0, v0 = apply_weight_norm(torch.from_numpy(w0))
    g = g0.clone().requires_grad_(True)
    v = v0.clone().requires_grad_(True)
    torch.sin(compute_weight(g, v)).sum().backward()
    jg0, jv0 = jwn.apply_weight_norm(w0)
    want = jax.grad(lambda g, v: jnp.sum(jnp.sin(jwn.compute_weight(g, v))),
                    argnums=(0, 1))(jg0, jv0)
    g2 = g0.clone().requires_grad_(True)
    v2 = v0.clone().requires_grad_(True)
    norm = torch.sqrt(torch.sum(v2 * v2, dim=1, keepdim=True))
    torch.sin(g2 * v2 / norm).sum().backward()
    for got, j, manual in ((g.grad, want[0], g2.grad),
                           (v.grad, want[1], v2.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got.numpy(), manual.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_fp16_safe_norm():
    """Norms that overflow fp16 (the apex motivation): values near the
    fp16 maximum must not give inf, since the norm runs in fp32."""
    import jax.numpy as jnp

    from apex_tpu import reparameterization as jwn

    v = torch.full((2, 1024), 200.0, dtype=torch.float16)
    g = torch.ones((2, 1), dtype=torch.float16)
    w = compute_weight(g, v)
    assert w.dtype == torch.float16
    assert bool(torch.isfinite(w.float()).all())
    want = jwn.compute_weight(jnp.ones((2, 1), jnp.float16),
                              jnp.full((2, 1024), 200.0, jnp.float16))
    np.testing.assert_array_equal(w.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
