"""Config-space fuzz of the port against the JAX package, on the CPU.

``tests/test_config_fuzz.py``'s encodings x networks x losses x optimizer
wrappers, plus HashGrids with ``"hash": "Rng"`` and with
``"stochastic_interpolation": true``, through both packages: the JAX
model's initial parameters and optimizer state carried into the port
(``load_jax_params``, ``load_jax_opt_state``), 4 training steps at 256
samples in each, then the losses and the predictions compared within
1e-5 relative (the loss against its own magnitude, the predictions against
their largest magnitude: the same fp32 operations, sums in another order),
and the port's ``serialize`` / ``deserialize`` round trip, through JSON,
into a model of another seed, bit for bit.  The sample of the cross
product is fixed (a seeded draw of 40 cases), so that every worker
collects the same tests.
"""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch.utils.jax_params import load_jax_opt_state, load_jax_params

from test_config_fuzz import ENCODINGS as JAX_FUZZ_ENCODINGS
from test_config_fuzz import LOSSES, NETWORKS, OPTIMIZERS

STOCHASTIC, RNG = len(JAX_FUZZ_ENCODINGS), len(JAX_FUZZ_ENCODINGS) + 1
ENCODINGS = JAX_FUZZ_ENCODINGS + [
    {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
     "log2_hashmap_size": 7, "base_resolution": 2, "per_level_scale": 2.0,
     "stochastic_interpolation": True},
    # one hashed level: JAX compiles the Rng hash's 64 steps per corner
    # unrolled, about 10 s a hashed level here
    {"otype": "HashGrid", "n_levels": 3, "n_features_per_level": 2,
     "log2_hashmap_size": 5, "base_resolution": 2, "per_level_scale": 2.0, "hash": "Rng"},
]
N_CASES = 40


def _cases():
    """39 cases drawn from the cross product without the Rng grid, and the
    Rng grid into the first network, loss and optimizer wrapper."""
    rng = np.random.RandomState(4321)
    combos = list(itertools.product([e for e in range(len(ENCODINGS)) if e != RNG],
                                    range(len(NETWORKS)), range(len(LOSSES)),
                                    range(len(OPTIMIZERS))))
    idx = rng.choice(len(combos), size=N_CASES - 1, replace=False)
    return [combos[i] for i in sorted(idx)] + [(RNG, 0, 0, 0)]


def test_the_sample_holds_the_new_grid_options():
    encs = [c[0] for c in _cases()]
    assert STOCHASTIC in encs and RNG in encs and len(set(_cases())) == N_CASES


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.mark.parametrize("ei,ni,li,oi", _cases())
def test_random_config_equals_jax(ei, ni, li, oi):
    cfg = {"loss": {"otype": LOSSES[li]}, "optimizer": OPTIMIZERS[oi],
           "encoding": ENCODINGS[ei], "network": NETWORKS[ni]}
    n_in, n_out, b = 2, 3, 256
    jmodel = jtcnn.create_from_config(n_in, n_out, cfg)
    state = jmodel.trainer.initial_state()
    model = tcnn.create_from_config(n_in, n_out, cfg, device="cpu")
    load_jax_params(model, _np_tree(state.params))
    load_jax_opt_state(model.trainer, _np_tree(state.opt_state))
    rng = np.random.default_rng(ei * 1000 + ni * 100 + li * 10 + oi)
    x = rng.uniform(0, 1, (b, n_in)).astype(np.float32)
    y = rng.uniform(0, 1, (b, n_out)).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for i in range(4):
        state, want = jmodel.trainer.training_step(state, jnp.asarray(x), jnp.asarray(y))
        got = model.trainer.training_step(xt, yt)
        want, got = float(want), float(got)
        assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want), (cfg, i, got, want)
    if ei == RNG:   # eager: its compilation takes 13 s here, running it a second
        with jax.disable_jit():
            want = np.asarray(jmodel.trainer.inference(state, jnp.asarray(x)))
    else:
        want = np.asarray(jmodel.trainer.inference(state, jnp.asarray(x)))
    pred = model.trainer.inference(xt)
    assert pred.shape == (b, n_out) and bool(torch.isfinite(pred).all())
    err = np.abs(pred.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (cfg, err, np.abs(want).max())

    blob = json.loads(json.dumps(model.trainer.serialize()))
    fresh = tcnn.create_from_config(n_in, n_out, cfg, device="cpu", seed=7)
    fresh.trainer.deserialize(blob)
    assert fresh.trainer.step == model.trainer.step == 4
    for name, p in model.trainer.params().items():
        assert torch.equal(fresh.trainer.params()[name], p), name
    assert torch.equal(fresh.trainer.inference(xt), pred)
