"""``tools/replay_check.py`` on the CPU: the lazy counters that recorded
gradients give, and the rule that holds two runs' optimizer states.

A small HashGrid + MLP (bf16 policy) trains from seeded numpy batches:
the lazy Adam counters of its grid (``param_steps``) must equal, entry
for entry, the count that ``record_gradients``' record of the run gives,
plain and under Batched.  Then hand-made states and gradients: two runs
whose counters differ at an entry pass only where their own gradients
give each run's count and differ between the runs.
"""

import numpy as np
import pytest
import torch

import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch.optimizers.base import ParamTree
from tcnn_tpu_torch.tools.replay_check import (counter_mismatches, lazy_counts,
                                                nested_interval, record_gradients)

ADAM = {"otype": "Adam", "learning_rate": 1e-2}
N_STEPS = 12


def _config(opt):
    return {"loss": {"otype": "RelativeL2"}, "optimizer": opt,
            "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                         "log2_hashmap_size": 8, "base_resolution": 4,
                         "per_level_scale": 1.5},
            "network": {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 2}}


@pytest.mark.parametrize("opt", [ADAM, {"otype": "Batched", "batch_size_multiplier": 4,
                                        "nested": ADAM}], ids=["Adam", "Batched"])
def test_lazy_counts_follow_the_recorded_gradients(opt):
    model = tcnn.create_from_config(2, 3, _config(opt), policy=tcnn.BF16_POLICY, device="cpu")
    bufs, i = record_gradients(model.trainer, N_STEPS)
    rng = np.random.default_rng(0)
    # few samples, so that most table entries get no gradient in a step
    batches = [(torch.from_numpy(rng.random((64, 2), dtype=np.float32)),
                torch.from_numpy(rng.random((64, 3), dtype=np.float32)))
               for _ in range(N_STEPS)]
    model.trainer.make_training_loop(lambda k: batches[k], N_STEPS)()
    assert int(i) == N_STEPS
    state = model.trainer.opt_state
    steps = (state["nested"] if "nested" in state else state)["param_steps"]["encoding.grid"]
    want = lazy_counts(bufs["encoding.grid"], nested_interval(model.optimizer))
    assert torch.equal(steps, want)
    assert 0 < int(want.max()) and int((want == 0).sum()) > 0


def _run(counts, grads, step=3):
    state = {"nested": {"param_steps": ParamTree({"encoding.grid": torch.tensor(
        counts, dtype=torch.int32)}), "step": torch.tensor(step, dtype=torch.int32)}}
    return state, {"encoding.grid": torch.tensor(grads, dtype=torch.float32).t()}


# Entry 1's four calls sum to exactly 0 in run b and to 2^-7 in run a.
G_A = [[1, 1, 1, 1], [0.5, -0.25, -0.25, 0.0078125], [0, 0, 0, 0]]
G_B = [[1, 1, 1, 1], [0.5, -0.25, -0.25, 0.0], [0, 0, 0, 0]]


@pytest.mark.parametrize("case, b_counts, b_grads, b_step, ok", [
    ("equal", [1, 1, 0], G_A, 3, True),
    ("explained", [1, 0, 0], G_B, 3, True),
    ("same gradients", [1, 0, 0], G_A, 3, False),
    ("not its own count", [1, 0, 2], [G_B[0], G_B[1], [0, 0, 1, 0]], 3, False),
    ("another integer leaf", [1, 1, 0], G_A, 4, False),
])
def test_counter_mismatches(case, b_counts, b_grads, b_step, ok):
    a_state, a_grads = _run([1, 1, 0], G_A)
    b_state, b_grads = _run(b_counts, b_grads, b_step)
    failed, witnesses = counter_mismatches(a_state, b_state, a_grads, b_grads, 4)
    assert (not failed) == ok, failed
    if case == "explained":
        (w,) = witnesses
        assert w["entry"] == [1] and w["counts"] == [1, 0]
        assert w["other gradients"] == {3: [0.0078125, 0.0]}
        assert w["means"] == [[0.001953125], [0.0]]
