"""The port's parallel layer (``tcnn_tpu_torch/parallel``) against the JAX
package's (``tcnn_tpu/parallel``), on the CPU.

The port's ranks are gloo processes (``torch_parallel_ranks``, no JAX); the
JAX side runs on the virtual CPU devices of ``tests/conftest.py``.  Both
start from the JAX model's initial parameters and optimizer state
(``utils.jax_params``) and take the same numpy batches, at
``tests/test_sharding.py``'s sizes (its config(): a 2-D hash grid of 4
levels and 2^10 rows, an MLP 32 x 2).  One spawn of 4 ranks runs
HybridParallel at (n_data, n_model) = (2, 2) and (1, 4) with Adam, (2, 2)
with Shampoo, with Average(Adam) and on a Composite of two grids, a
table-sharded inference and
DataParallel at 4 ranks; one spawn of 2 runs DataParallel at 2, the noise
streams of output perturbation, a sharded checkpoint round trip (n_model
2), the layout tag, the serialization guard and ``replicate`` from ranks
that start apart.  Each run's first reduced gradients are compared with
JAX's one-process gradients.  The runs at (2, 2), (1, 4) and DataParallel
at 2 also train through ``make_training_loop`` and through eager
``step_shard_map`` steps that the caller counts, against the
``make_training_step`` steps (bit for bit: on the CPU every compiled entry
point runs the eager steps) and JAX's ``lax.scan`` of its
``step_shard_map``.  Each spawn also asks both layers' compiled entry
points for a trainer on a card over gloo, which must refuse.  The
launcher runs as a module in 2 CPU processes, with a resume.

Tolerances: HybridParallel's losses rtol 5e-4 and its gathered tables rtol
5e-3, atol 1e-6 (JAX's own test_loss_curve_matches_single_device: fp32
partial sums in another order, which Adam's rsqrt magnifies over steps);
DataParallel's losses rtol 5e-4 and parameters rtol 5e-3, atol 1e-6 (the
same); the table-sharded inference rtol 1e-5, atol 1e-6 (JAX's
test_sharded_inference); the first reduced gradients per entry within
1e-5 of each leaf's largest magnitude (one gradient, no optimizer).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import tcnn_tpu as jtcnn
from tcnn_tpu.parallel import DataParallel, HybridParallel, make_mesh

import torch_parallel_ranks as ranks

REPO = Path(__file__).resolve().parents[1]


def config(opt=None):
    return {
        "loss": {"otype": "L2"},
        "optimizer": opt or {"otype": "Adam", "learning_rate": 1e-2},
        "encoding": {"otype": "HashGrid", "n_levels": 4,
                     "n_features_per_level": 2, "log2_hashmap_size": 10,
                     "base_resolution": 4, "per_level_scale": 1.5},
        "network": {"otype": "MLP", "n_neurons": 32, "n_hidden_layers": 2},
    }


def composite_config():
    """tests/test_sharding.py's test_composite_btf_style_grids: two 2-D hash
    grids on a 4-D input, both tables sharded."""
    grid = {"otype": "HashGrid", "n_dims_to_encode": 2, "n_levels": 4,
            "n_features_per_level": 2, "log2_hashmap_size": 10,
            "base_resolution": 4, "per_level_scale": 1.5}
    return {"loss": {"otype": "RelativeL2"},
            "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
            "encoding": {"otype": "Composite", "nested": [grid, dict(grid)]},
            "network": {"otype": "MLP", "n_neurons": 32, "n_hidden_layers": 2}}


SHAMPOO = {"otype": "Shampoo", "learning_rate": 1e-2}
AVERAGE = {"otype": "Average", "n_samples": 3,
           "nested": {"otype": "Adam", "learning_rate": 1e-2}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _named(tree):
    """{"encoding.grid": array, "network.layers.0": ...}: a JAX tree's
    leaves under the port's parameter names."""
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_first_grads(model, params, bs):
    """The gradients of the training loss on the whole first global batch
    at the initial parameters, in one process."""
    if not bs:
        return None
    _, grads = model.trainer.loss_value_and_grads(params, *bs[0])
    return _named(grads)


def batches(seed, n, batch, n_in=2):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (batch, n_in)).astype(np.float32),
             rng.uniform(0, 1, (batch, 3)).astype(np.float32)) for _ in range(n)]


def jax_scan(dp, sm_step, state, state_shardings, bs):
    """The JAX launcher's compiled loop (``tcnn_tpu/parallel/launch.py:
    165-175``) over the numpy batches ``bs``: ``lax.scan`` of the
    ``shard_map`` step, each step's batch constrained to the batch
    sharding, under ``jax.jit`` with the state's shardings.  Returns the
    final state and the losses."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    xs = np.stack([x for x, _ in bs])
    ts = np.stack([t for _, t in bs])

    def loop(state, xs, ts):
        def body(st, xt):
            x = jax.lax.with_sharding_constraint(xt[0], dp.batch_sharding)
            t = jax.lax.with_sharding_constraint(xt[1], dp.batch_sharding)
            return sm_step(st, x, t)

        return jax.lax.scan(body, state, (xs, ts))

    replicated = NamedSharding(dp.mesh, P())
    state, losses = jax.jit(loop, in_shardings=(state_shardings, None, None),
                            out_shardings=(state_shardings, replicated))(state, xs, ts)
    return state, [float(v) for v in np.asarray(losses)]


def jax_hybrid(cfg, n_data, n_model, bs, infer=None, loop=False):
    """The run's payload and JAX's reference; with ``loop``, also the port's
    ``make_training_loop`` over the batches and JAX's scanned step."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_in = bs[0][0].shape[1] if bs else 2
    model = jtcnn.create_from_config(n_in, 3, cfg)
    state0 = model.trainer.initial_state()
    run = {"config": cfg, "n_in": n_in, "n_model": n_model, "batches": bs, "infer": infer,
           "params": _np_tree(state0.params), "opt_state": _np_tree(state0.opt_state),
           "loop": loop}
    hp = HybridParallel(n_model=n_model, devices=jax.devices()[:n_data * n_model], model=model)
    state = hp.shard_state(state0)
    step = hp.make_training_step(model.trainer)
    losses = []
    for x, t in bs:
        state, loss = step(state, hp.shard_batch(x), hp.shard_batch(t))
        losses.append(float(loss))
    ref = {"losses": losses, "gathered": hp.gather_state(state),
           "grads": jax_first_grads(model, state0.params, bs)}
    if infer is not None:
        ref["y"] = np.asarray(model.trainer.forward(state0, infer))
    if loop:   # from a fresh initial state: the eager steps donated the old one's leaves
        state0 = model.trainer.initial_state()
        shardings = jax.tree_util.tree_map(lambda s: NamedSharding(hp.mesh, s),
                                           hp.specs(state0), is_leaf=lambda v: isinstance(v, P))
        state, ref["scan losses"] = jax_scan(hp, hp.step_shard_map(model.trainer)(state0),
                                             hp.shard_state(state0), shardings, bs)
        ref["scan gathered"] = hp.gather_state(state)
    return run, ref


def jax_data_parallel(cfg, n, bs, loop=False):
    """As ``jax_hybrid``, for DataParallel over ``n`` devices."""
    model = jtcnn.create_from_config(2, 3, cfg)
    state0 = model.trainer.initial_state()
    run = {"config": cfg, "n_in": 2, "batches": bs, "loop": loop,
           "params": _np_tree(state0.params), "opt_state": _np_tree(state0.opt_state)}
    dp = DataParallel(make_mesh(jax.devices()[:n]))
    step = dp.make_training_step(model.trainer)
    state = dp.replicate(state0)
    losses = []
    for x, t in bs:
        state, loss = step(state, dp.shard_batch(x), dp.shard_batch(t))
        losses.append(float(loss))
    ref = {"losses": losses, "params": jax.device_get(state.params),
           "grads": jax_first_grads(model, state0.params, bs)}
    if loop:
        state, ref["scan losses"] = jax_scan(dp, dp.step_shard_map(model.trainer),
                                             dp.replicate(model.trainer.initial_state()),
                                             dp.replicated, bs)
        ref["scan params"] = jax.device_get(state.params)
    return run, ref


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The 4-rank spawn and its JAX references."""
    runs, refs = {}, {}
    for name, cfg, shape, n_steps, b in (
            ("adam22", config(), (2, 2), 4, 2 * 64), ("adam14", config(), (1, 4), 4, 64),
            ("shampoo22", config(SHAMPOO), (2, 2), 3, 128),
            ("average22", config(AVERAGE), (2, 2), 3, 128)):
        runs[name], refs[name] = jax_hybrid(cfg, *shape, batches(len(name) + b, n_steps, b),
                                            loop=name in LOOP_RUNS)
    runs["composite22"], refs["composite22"] = jax_hybrid(composite_config(), 2, 2,
                                                          batches(13, 3, 2 * 64, n_in=4))
    infer = np.random.default_rng(1).uniform(0, 1, (4 * 32, 2)).astype(np.float32)
    runs["infer14"], refs["infer14"] = jax_hybrid(config(), 1, 4, [], infer)
    dp_run, dp_ref = jax_data_parallel(config(), 4, batches(4, 3, 4 * 64))
    outs = ranks.run(4, tmp_path_factory.mktemp("parallel4"), "parallel",
                     {"hybrid": runs, "data": {"dp4": dp_run}})
    return outs, {**refs, "dp4": dp_ref}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """The 2-rank spawn (DataParallel, noise, checkpoints, guard)."""
    dp_run, dp_ref = jax_data_parallel(config(), 2, batches(2, 3, 2 * 64), loop=True)
    noise_run, _ = jax_data_parallel(config(), 2, batches(7, 1, 2 * 64))
    guard_run, _ = jax_data_parallel(config(), 2, batches(9, 1, 2 * 64))
    guard_run["n_model"] = 2
    tmp = tmp_path_factory.mktemp("parallel2")
    outs = ranks.run(2, tmp, "parallel", {"hybrid": {}, "data": {"dp2": dp_run},
                                          "noise": noise_run, "guard": guard_run,
                                          "replicate": noise_run,
                                          "tmp": str(tmp / "work")})
    return outs, {"dp2": dp_ref, "replicate": noise_run}


GRID = "encoding.grid"
LOOP_RUNS = ("adam22", "adam14", "dp2")   # runs that also train through make_training_loop


@pytest.mark.parametrize("name", ["adam22", "adam14", "shampoo22", "average22"])
def test_hybrid_losses_and_gathered_table_match_jax(four, name):
    outs, refs = four
    ref = refs[name]
    for o in outs:
        np.testing.assert_allclose(o[name]["losses"], ref["losses"], rtol=5e-4)
        np.testing.assert_allclose(o[name]["params"][GRID],
                                   np.asarray(ref["gathered"].params["encoding"]["grid"]),
                                   rtol=5e-3, atol=1e-6)
    # the MLP stays replicated: every rank ends with the same weights
    for k, v in outs[0][name]["params"].items():
        for o in outs[1:]:
            np.testing.assert_array_equal(o[name]["params"][k], v)


@pytest.mark.parametrize("name", ["adam22", "adam14", "shampoo22", "average22"])
def test_hybrid_shards_the_table_and_its_mirrors(four, name):
    """The table and every optimizer leaf that mirrors it hold a 1/n_model
    block on each rank; the MLP's leaves stay whole."""
    outs, refs = four
    n_model = 4 if name == "adam14" else 2
    o = outs[0][name]
    n = np.asarray(refs[name]["gathered"].params["encoding"]["grid"]).size
    assert o["sharded"] == (GRID,)
    assert o["shapes"][GRID] == (n // n_model,)
    mirrors = {p: s for p, s in o["state_shapes"].items() if p.endswith(GRID)}
    assert mirrors and all(s[-1] == n // n_model for s in mirrors.values())
    if name == "average22":
        assert mirrors["buffer." + GRID] == (3, n // n_model)
        # the ring buffer gathers back to the canonical row order
        np.testing.assert_allclose(o["opt"]["buffer." + GRID],
                                   np.asarray(refs[name]["gathered"].opt_state["buffer"]
                                              ["encoding"]["grid"]), rtol=5e-3, atol=1e-6)
    others = {p: s for p, s in o["state_shapes"].items() if not p.endswith(GRID)}
    assert all(n // n_model not in s[-1:] for s in others.values())


def test_composite_shards_both_nested_tables(four):
    """Both nested grid tables of a Composite shard (JAX's
    test_composite_btf_style_grids), and the losses match JAX's."""
    outs, refs = four
    ref = refs["composite22"]
    for o in outs:
        assert o["composite22"]["sharded"] == ("encoding.0.grid", "encoding.1.grid")
        np.testing.assert_allclose(o["composite22"]["losses"], ref["losses"], rtol=5e-4)
        for i in (0, 1):
            np.testing.assert_allclose(
                o["composite22"]["params"][f"encoding.{i}.grid"],
                np.asarray(ref["gathered"].params["encoding"][i]["grid"]), rtol=5e-3, atol=1e-6)


def test_hybrid_inference_matches_jax(four):
    outs, refs = four
    got = np.concatenate([o["infer14"]["y"] for o in outs])
    np.testing.assert_allclose(got, refs["infer14"]["y"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_data_parallel_matches_jax(four, two, n):
    outs, refs = (four if n == 4 else two)
    ref = refs[f"dp{n}"]
    for o in outs:
        assert o[f"dp{n}"]["n_devices"] == n
        np.testing.assert_allclose(o[f"dp{n}"]["losses"], ref["losses"], rtol=5e-4)
        params = o[f"dp{n}"]["params"]
        np.testing.assert_allclose(params[GRID], np.asarray(ref["params"]["encoding"]["grid"]),
                                   rtol=5e-3, atol=1e-6)
        flat = jax.tree_util.tree_leaves(ref["params"]["network"])
        mine = [params[k] for k in sorted(params) if k.startswith("network.")]
        assert len(flat) == len(mine)
        for a, b in zip(mine, flat):
            np.testing.assert_allclose(a, np.asarray(b), rtol=5e-3, atol=1e-6)


@pytest.mark.parametrize("name", ["adam22", "adam14", "shampoo22", "average22", "composite22",
                                  "dp4", "dp2"])
def test_first_reduced_gradients_match_jax(four, two, name):
    """The gradients the first step hands the optimizer (reduced over the
    ranks, each table gathered) equal JAX's one-process gradients of the
    whole first batch per entry, within 1e-5 of each leaf's largest
    magnitude: a gradient of the wrong scale, which Adam's update hides,
    fails here."""
    outs, refs = two if name == "dp2" else four
    want = refs[name]["grads"]
    for o in outs:
        got = o[name]["grads"]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                       err_msg=k)


@pytest.mark.parametrize("name", LOOP_RUNS)
def test_training_loop_equals_eager_steps_bit_for_bit(four, two, name):
    """On the CPU (gloo) ``make_training_loop`` runs the eager steps: N
    steps of the loop give the losses, parameters, optimizer state and step
    of N calls of ``make_training_step``, bit for bit."""
    outs, _ = two if name == "dp2" else four
    for o in outs:
        assert o[name]["loop"]["losses"] == o[name]["losses"]
        assert o[name]["loop"]["state equal"]


@pytest.mark.parametrize("name", LOOP_RUNS)
def test_step_shard_map_equals_make_training_step_bit_for_bit(four, two, name):
    """``step_shard_map``'s eager body, each step counted by the caller
    (the body leaves ``trainer.step`` alone), gives the losses,
    parameters, optimizer state and step of ``make_training_step``'s
    steps, bit for bit."""
    outs, _ = two if name == "dp2" else four
    for o in outs:
        assert o[name]["shard_map"]["uncounted"]
        assert o[name]["shard_map"]["losses"] == o[name]["losses"]
        assert o[name]["shard_map"]["state equal"]


@pytest.mark.parametrize("name", LOOP_RUNS)
def test_step_shard_map_matches_jax_step_shard_map(four, two, name):
    """The eager ``step_shard_map`` steps against JAX's ``step_shard_map``
    over the same batches (scanned, as the JAX launcher runs it), within
    the eager tests' tolerances: losses rtol 5e-4, tables and weights
    rtol 5e-3, atol 1e-6."""
    outs, refs = two if name == "dp2" else four
    ref = refs[name]
    for o in outs:
        got = o[name]["shard_map"]
        np.testing.assert_allclose(got["losses"], ref["scan losses"], rtol=5e-4)
        want = (_named(ref["scan params"]) if name == "dp2"
                else _named(ref["scan gathered"].params))
        assert sorted(got["params"]) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got["params"][k], w, rtol=5e-3, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", LOOP_RUNS)
def test_training_loop_matches_jax_scanned_step(four, two, name):
    """The loop's losses and trained parameters against JAX's
    ``lax.scan`` of ``step_shard_map`` over the same batches (the JAX
    launcher's loop), within the eager tests' tolerances: losses rtol 5e-4,
    tables and weights rtol 5e-3, atol 1e-6."""
    outs, refs = two if name == "dp2" else four
    ref = refs[name]
    for o in outs:
        got = o[name]["loop"]
        np.testing.assert_allclose(got["losses"], ref["scan losses"], rtol=5e-4)
        want = (_named(ref["scan params"]) if name == "dp2"
                else _named(ref["scan gathered"].params))
        assert sorted(got["params"]) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got["params"][k], w, rtol=5e-3, atol=1e-6, err_msg=k)


def test_capture_check_refuses_gloo_on_cuda(two):
    """``collectives.check_capturable``: a CUDA loop over gloo raises
    (gloo's collectives cannot be captured in a CUDA graph); on the CPU
    the loop runs eagerly over gloo.  Each layer's ``make_training_loop``,
    ``make_training_step`` and ``make_inference`` for a trainer on a card
    over gloo raise when they are asked for, before any step or batch,
    and name themselves (the steps' message names ``step_shard_map`` for
    eager steps)."""
    outs, _ = two
    for o in outs:
        assert "gloo" in o["capture check"]["cuda"]
        assert "cannot be captured" in o["capture check"]["cuda"]
        assert o["capture check"]["cpu"] is None
        for layer, got in o["compiled on cuda"].items():
            for entry, name in (("loop", "make_training_loop"), ("step", "make_training_step"),
                                ("inference", "make_inference")):
                msg = got[entry]
                assert msg and msg.startswith(name + ":"), (layer, entry, msg)
                assert "gloo" in msg and "cannot be captured" in msg, (layer, entry, msg)
            assert "step_shard_map" in got["step"] and "step_shard_map" in got["loop"]


@pytest.mark.parametrize("entry", ["make_training_step", "make_inference"])
def test_use_shard_map_false_has_no_counterpart(entry):
    """JAX's ``use_shard_map=False`` (a plain jit left to XLA's
    partitioner) raises ``TypeError``; its default is accepted."""
    import tcnn_tpu_torch as tcnn
    from tcnn_tpu_torch.parallel import DataParallel as TorchDataParallel

    trainer = tcnn.create_from_config(2, 3, config(), device="cpu").trainer
    dp = TorchDataParallel()
    with pytest.raises(TypeError, match="use_shard_map"):
        getattr(dp, entry)(trainer, use_shard_map=False)
    assert callable(getattr(dp, entry)(trainer, use_shard_map=True))


def test_replicate_broadcasts_rank_zeros_state(two):
    """Ranks that start from different parameters, optimizer state and
    step all end with rank 0's (the JAX model's initial parameters)."""
    outs, refs = two
    first = outs[0]["replicate"]
    assert first["step"] == 0
    for o in outs[1:]:
        assert o["replicate"]["step"] == 0
        assert sorted(o["replicate"]["leaves"]) == sorted(first["leaves"])
        for k, v in first["leaves"].items():
            np.testing.assert_array_equal(o["replicate"]["leaves"][k], v, err_msg=k)
    params = _named(refs["replicate"]["params"])
    for k, v in params.items():
        np.testing.assert_array_equal(first["leaves"][f"param {k}"], v, err_msg=k)


def test_perturbation_noise_streams_differ_across_ranks_and_are_logistic(two):
    outs, _ = two
    a, b = (o["noise"]["noise"] for o in outs)
    assert not np.array_equal(a, b)
    assert ranks.logistic_ok(a) and ranks.logistic_ok(b)
    # the perturbed step's loss differs from the unperturbed one on the same data
    assert abs(outs[0]["noise"]["loss 0.5"] - outs[0]["noise"]["loss None"]) > 1e-6


def test_sharded_checkpoint_round_trip_and_layout_tag(two):
    outs, _ = two
    for r, o in enumerate(outs):
        g = o["guard"]
        assert g["files"] == ["state.rank0.pt", "state.rank1.pt"]
        assert g["restored equal"]
        assert g["next step"][0] == g["next step"][1]
        assert "permuted grid tables" in g["tag refuses"]
        assert g["manager steps"] == [4, 5]   # steps 1-2 before, 3-5 saved, 2 kept


def test_serialization_guard_then_gather_state_serializes_as_before(two):
    outs, _ = two
    for o in outs:
        g = o["guard"]
        for what in ("serialize", "export_snapshot", "export_inference"):
            assert "gather_state" in g[f"guard {what}"], what
        assert g["blob params equal"] and g["blob optimizer equal"] and g["blob n_params equal"]


def test_bad_mesh_raises(four):
    outs, _ = four
    for o in outs:
        assert "divisible" in o["bad mesh"]
        assert "n_model" in o["no n_model"]


def _chunk_losses(out):
    """{step: loss} from the launcher's "steps a-b: losses [...]" lines."""
    got = {}
    for line in out.splitlines():
        if line.startswith("steps "):
            span, values = line[len("steps "):].split(": losses ")
            first = int(span.split("-")[0])
            got.update({first + i: v for i, v in enumerate(json.loads(values))})
    return got


@pytest.mark.parametrize("n_model", [1, 2])
def test_launcher_trains_two_cpu_ranks_and_resumes(tmp_path, n_model):
    """``python -m tcnn_tpu_torch.parallel.launch`` at 2 CPU ranks (gloo, a
    file:// rendezvous): 6 steps through ``make_training_loop`` in chunks
    of 2 with checkpoints every 2; then, with step 6's checkpoint removed,
    a second run to 6 steps resumes from step 4 and gives steps 5 and 6
    the first run's losses bit for bit."""
    ckpt = tmp_path / "ckpt"

    def launch(steps, tag):
        env = dict(os.environ, WORLD_SIZE="2", OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        cmd = [sys.executable, "-m", "tcnn_tpu_torch.parallel.launch", "--device", "cpu",
               "--init-method", f"file://{tmp_path / f'init{tag}'}", "--steps", str(steps),
               "--batch", "1024", "--chunk", "2", "--n-model", str(n_model),
               "--ckpt-dir", str(ckpt)]
        procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r)), cwd=REPO,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        outs = [p.communicate(timeout=240)[0] for p in procs]
        assert all(p.returncode == 0 for p in procs), outs
        return outs[0]

    first = launch(6, "a")
    assert "make_training_loop" in first and "trained 6 steps of batch 1024" in first
    files = sorted(p.name for p in (ckpt / "4").iterdir())
    assert files == (["state.rank0.pt", "state.rank1.pt"] if n_model == 2 else ["state.pt"])
    shutil.rmtree(ckpt / "6")
    second = launch(6, "b")
    assert "resumed from step 4" in second and "trained 2 steps" in second
    before, after = _chunk_losses(first), _chunk_losses(second)
    assert sorted(before) == list(range(1, 7)) and sorted(after) == [5, 6]
    assert all(np.isfinite(v) for v in before.values())
    assert after == {5: before[5], 6: before[6]}
