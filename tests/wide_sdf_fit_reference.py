"""The JAX package's run of the wide SDF fit that ``chip_smoke.py``'s
wide-features phase takes its loss floor from (not a test: run it on the CPU).

    JAX_PLATFORMS=cpu python tests/wide_sdf_fit_reference.py [n_steps] [batch_pow] [log2_rows]

The SDF sample's fit (``samples/fit_sdf_eikonal.py``: its surface and
eikonal terms, Adam 1e-3, Smoothstep) with a wide model: a 3-D HashGrid of
16 levels x 16 features into a FullyFusedMLP 128 x 2 (256 inputs), tables
of 2^log2_rows rows (15 by default: the card's fit runs the same size).
Prints the loss every 50 steps and the mean of the last 10 steps' losses,
the figure the floor is set from.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import tcnn_tpu as tcnn  # noqa: E402


def wide_config(base, log2_rows):
    """The SDF sample's config with the wide grid and network."""
    return {**base,
            "encoding": {**base["encoding"], "n_levels": 16, "n_features_per_level": 16,
                         "log2_hashmap_size": log2_rows},
            "network": {**base["network"], "n_neurons": 128, "n_hidden_layers": 2}}


def main(argv):
    n_steps = int(argv[1]) if len(argv) > 1 else 200
    batch = 1 << (int(argv[2]) if len(argv) > 2 else 14)
    log2_rows = int(argv[3]) if len(argv) > 3 else 15
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "samples"))
    from fit_sdf_eikonal import CENTER, CONFIG, RADIUS

    model = tcnn.create_from_config(3, 1, wide_config(CONFIG, log2_rows), policy=tcnn.Policy())
    net, opt = model.network, model.optimizer
    params = net.init(jax.random.key(0))
    opt_state = opt.init(params, net.param_layout(params))

    def f(p, x):
        return net.apply(p, x)[:, 0]

    def loss_fn(p, key):
        k1, k2 = jax.random.split(key)
        d = jax.random.normal(k1, (batch, 3))
        x_surf = CENTER + RADIUS * d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        x_vol = jax.random.uniform(k2, (batch, 3), minval=0.05, maxval=0.95)
        surf = jnp.mean(f(p, x_surf) ** 2)
        gx = jax.grad(lambda z: jnp.sum(f(p, z)))(x_vol)
        eik = jnp.mean((jnp.sqrt(jnp.sum(gx * gx, axis=-1) + 1e-12) - 1.0) ** 2)
        return surf + 0.1 * eik

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
