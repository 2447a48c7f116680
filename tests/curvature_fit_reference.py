"""The JAX package's run of the curvature fit that ``chip_smoke.py``'s
slice-14 phase takes its loss floor from (not a test: run it on the CPU).

    JAX_PLATFORMS=cpu python tests/curvature_fit_reference.py [n_steps] [batch_pow] [act]

The SDF sample's model and optimizer (``samples/fit_sdf_eikonal.py``:
HashGrid 8 × 2, 2^15 rows, Smoothstep, FullyFusedMLP 64 × 2, Adam 1e-3),
its surface and eikonal terms, plus the port's curvature regulariser
(``tcnn_tpu_torch/samples/fit_sdf_eikonal.py::curvature_loss``): λ · mean
|H v|², H the Hessian of f in x at the volume points and v a random unit
direction per point, λ = 1e-3.  Prints the loss every 50 steps and the
mean of the last 10 steps' losses, the figure the floor is set from.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import tcnn_tpu as tcnn  # noqa: E402

CURVATURE_WEIGHT = 1e-3


def main(argv):
    n_steps = int(argv[1]) if len(argv) > 1 else 200
    batch = 1 << (int(argv[2]) if len(argv) > 2 else 14)
    act = argv[3] if len(argv) > 3 else "ReLU"
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "samples"))
    from fit_sdf_eikonal import CENTER, CONFIG, RADIUS

    cfg = {**CONFIG, "network": {**CONFIG["network"], "activation": act}}
    model = tcnn.create_from_config(3, 1, cfg, policy=tcnn.Policy())
    net, opt = model.network, model.optimizer
    params = net.init(jax.random.key(0))
    opt_state = opt.init(params, net.param_layout(params))

    def f(p, x):
        return net.apply(p, x)[:, 0]

    def loss_fn(p, key):
        k1, k2, k3 = jax.random.split(key, 3)
        d = jax.random.normal(k1, (batch, 3))
        x_surf = CENTER + RADIUS * d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        x_vol = jax.random.uniform(k2, (batch, 3), minval=0.05, maxval=0.95)
        v = jax.random.normal(k3, (batch, 3))
        v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
        surf = jnp.mean(f(p, x_surf) ** 2)

        def grad_x(xx):
            return jax.grad(lambda z: jnp.sum(f(p, z)))(xx)
        gx = grad_x(x_vol)
        eik = jnp.mean((jnp.sqrt(jnp.sum(gx * gx, axis=-1) + 1e-12) - 1.0) ** 2)
        hv = jax.grad(lambda z: jnp.sum(grad_x(z) * v))(x_vol)
        return surf + 0.1 * eik + CURVATURE_WEIGHT * jnp.mean(jnp.sum(hv * hv, axis=-1))

    @jax.jit
    def step(p, s, key):
        loss, grads = jax.value_and_grad(loss_fn)(p, key)
        s, p = opt.step(s, grads, p)
        return p, s, loss

    key = jax.random.key(1)
    losses = []
    t0 = time.perf_counter()
    for i in range(n_steps):
        key, sub = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, sub)
        losses.append(float(loss))
        if i % 50 == 0 or i == n_steps - 1:
            print(f"step {i}: loss={losses[-1]:.6f}", flush=True)
    print(f"{n_steps} steps in {time.perf_counter() - t0:.1f}s")
    print(f"first loss {losses[0]:.6f}, mean of the last 10: {np.mean(losses[-10:]):.6f}")


if __name__ == "__main__":
    main(sys.argv)
