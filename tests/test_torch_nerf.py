"""The port's NeRF field sample, image IO and image sample against the JAX
package, on the CPU.

The JAX samples are loaded by path, as ``tests/test_samples.py`` loads
them; the parameters come from the JAX ``init`` of each of the two nets
through ``load_jax_params``; rays and jitter are made with numpy from a
seed and given to both sides.  Tolerances:
  * the NeRF render (64 rays × 8 samples, fp32 policy, JAX with
    ``key=None`` and the port without jitter), at ``max_level_frac`` None,
    0.0, 0.37 and 1.0: the rendered colours within 1e-5 (they are O(1)
    sums over 8 samples of the same fp32 operations), the loss within 1e-5
    relative, and every gradient of both nets within 1e-4 of its largest
    magnitude (sums over 512 samples in another order, and a softplus and
    a cumulative product differentiated by two libraries);
  * the port's sample trains: 80 steps at 256 rays × 8 samples bring the
    mean loss of the last 10 steps below 0.6× that of the first 10, the
    criterion of ``tests/test_samples.py``;
  * sRGB conversions: rtol 1e-6 against JAX's (the same numpy code);
    every file written byte for byte as JAX writes it; 8-bit PNG round
    trips within two 1/255 steps in linear (half a step after the gamma),
    JPEG within 0.01 on average; the fp16 ``.bin`` format exactly.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
import tcnn_tpu_torch as tcnn
from tcnn_tpu.utils import image as jimage
from tcnn_tpu_torch.samples import fit_nerf_field as tnf
from tcnn_tpu_torch.samples import mlp_learning_an_image as timg
from tcnn_tpu_torch.utils import image as timage
from tcnn_tpu_torch.utils.jax_params import load_jax_params

SAMPLES = os.path.join(os.path.dirname(__file__), "..", "samples")
REPO = os.path.join(os.path.dirname(__file__), "..")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_sample_{name}", os.path.join(SAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jnf():
    return _load("fit_nerf_field")


@pytest.fixture(scope="module")
def nets(jnf):
    """The JAX sample's two nets at the fp32 policy, their JAX parameters,
    and the port's two nets holding the same parameters."""
    jd, jc = jnf.build_model(jtcnn.Policy())
    k0, k1 = jax.random.split(jax.random.key(0))
    params = {"density": jd.init(k0), "color": jc.init(k1)}
    td, tc = tnf.build_model(tcnn.Policy(), device="cpu")
    load_jax_params(td, jax.tree_util.tree_map(np.asarray, params["density"]))
    load_jax_params(tc, jax.tree_util.tree_map(np.asarray, params["color"]))
    return jd, jc, params, td, tc


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = 0.5 + 1.2 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(0.25, 0.75, (n, 3)).astype(np.float32) - o
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return np.asarray(tree)


def test_model_matches_the_jax_sample(jnf, nets):
    jd, jc, _, td, tc = nets
    assert td.hyperparams() == jd.hyperparams() and tc.hyperparams() == jc.hyperparams()
    assert [tuple(w.shape) for w in td.network.layers] == [(24, 64), (64, 16)]
    assert [tuple(w.shape) for w in tc.network.layers] == [(31, 64), (64, 64), (64, 3)]
    assert td.encoding.spec.n_levels == 12 and tc.encoding.n_output_dims == 31


@pytest.mark.parametrize("frac", [None, 0.0, 0.37, 1.0])
def test_render_loss_and_gradients_equal_jax(jnf, nets, frac):
    jd, jc, params, td, tc = nets
    n_rays, n_samples = 64, 8
    o, d = _rays(n_rays, seed=3)

    def jloss(p):
        gt = jnf.render(lambda x, v: jnf.true_field(x), jnp.asarray(o), jnp.asarray(d),
                        n_samples)
        pred = jnf.render(lambda x, v: jnf.model_field(jd, jc, p, x, v, max_level_frac=frac),
                          jnp.asarray(o), jnp.asarray(d), n_samples)
        return jnp.mean((pred - gt) ** 2), pred

    (want_loss, want_pred), want_grads = jax.value_and_grad(jloss, has_aux=True)(params)

    to, td_ = torch.from_numpy(o), torch.from_numpy(d)
    got_pred = tnf.render(lambda x, v: tnf.model_field(td, tc, x, v, frac), to, td_, n_samples)
    np.testing.assert_allclose(got_pred.detach().numpy(), np.asarray(want_pred), rtol=1e-5,
                               atol=1e-5)
    loss, grads = tnf.loss_and_grads(td, tc, to, td_, n_samples, max_level_frac=frac)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    params_t, layout = tnf.params_and_layout(td, tc)
    assert set(grads) == set(params_t) == set(layout)
    assert layout["density.encoding.grid"] == "other"
    for name, g in grads.items():
        want = _leaf(want_grads, name)
        assert g.shape == want.shape, name
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_plain_path_equals_the_step_on_the_cpu(policy):
    """``tools.plain_path.plain_nerf_loss_and_grads``, which ``chip_smoke.py``
    holds the card's step against, takes the kernel path's order on the
    CPU, where the wrappers run the same plain versions: the same loss
    and gradients, to fp32 rounding (autograd sums the two gradients of
    the density net's output in its own order)."""
    from tcnn_tpu_torch.tools.plain_path import plain_nerf_loss_and_grads

    pol = tcnn.BF16_POLICY if policy == "bf16" else tcnn.Policy()
    td, tc = tnf.build_model(pol, torch.Generator().manual_seed(1), "cpu")
    o, d = (torch.from_numpy(a) for a in _rays(48, seed=6))
    jitter = torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (48, 8)).astype(np.float32))
    loss, grads = tnf.loss_and_grads(td, tc, o, d, 8, jitter, 0.45)
    want_loss, want = plain_nerf_loss_and_grads(td, tc, o, d, 8, jitter, 0.45)
    assert set(grads) == set(want)
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)
    for name, g in grads.items():
        torch.testing.assert_close(g, want[name], rtol=0,
                                   atol=1e-6 * float(want[name].abs().max()), msg=name)


def test_coarse_to_fine_masks_the_density_grid(nets):
    """frac = 0 leaves level 0 alone: the grid's table gradient reaches
    only level 0's rows, as the JAX sample's schedule intends."""
    _, _, _, td, tc = nets
    o, d = (torch.from_numpy(a) for a in _rays(32, seed=4))
    _, grads = tnf.loss_and_grads(td, tc, o, d, 8, max_level_frac=0.0)
    spec = td.encoding.spec
    level0 = spec.levels[0].size * spec.n_features_per_level
    g = grads["density.encoding.grid"]
    assert bool(g[:level0].any()) and not bool(g[level0:].any())


def test_schedule_and_camera_match_jax(jnf):
    n_steps = 400
    warm = min(n_steps // 4, 100)
    for i in (0, 1, 50, 98, 99, 100, 399):
        want = min((i + 1) / max(warm, 1), 1.0) if i < warm else 1.0
        assert tnf.coarse_to_fine(i, n_steps) == want
    jo, jd = jnf.camera_rays(8)
    to, td = tnf.camera_rays(8, "cpu")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    x = np.random.default_rng(5).uniform(0, 1, (100, 3)).astype(np.float32)
    for got, want in zip(tnf.true_field(torch.from_numpy(x)), jnf.true_field(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_sample_rays_are_unit_directions_at_radius_1_2():
    gen = torch.Generator().manual_seed(1)
    o, d = tnf.sample_rays(gen, 1000, "cpu")
    torch.testing.assert_close(torch.linalg.norm(o - 0.5, dim=-1), torch.full((1000,), 1.2))
    torch.testing.assert_close(torch.linalg.norm(d, dim=-1), torch.ones(1000))


def test_short_training_reduces_loss(monkeypatch, capsys):
    """The port's sample on the CPU (plain versions, fp32 policy): 80 steps
    of 256 rays × 8 samples, the criterion of tests/test_samples.py."""
    monkeypatch.setenv("NERF_SAMPLES", "8")
    monkeypatch.setenv("NERF_EVAL_RES", "8")
    out = tnf.main(["x", "80", "8"], device="cpu")
    losses = out["losses"]
    assert losses.shape == (80,) and bool(torch.isfinite(losses).all())
    head, tail = float(losses[:10].mean()), float(losses[-10:].mean())
    assert tail < 0.6 * head, (head, tail)
    assert np.isfinite(out["psnr"]) and "eval PSNR" in capsys.readouterr().out


def test_samples_need_a_device_or_the_cpu_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tnf.main(["x", "1", "4"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        timg.main(["x", "none", "configs/config_hash.json", "1"])


# -- image IO ------------------------------------------------------------------


def test_srgb_conversions_equal_jax():
    v = np.random.default_rng(0).uniform(0.0, 1.2, (37, 11, 3)).astype(np.float32)
    v[0, :5, 0] = [0.0, 0.04045, 0.0031308, 1.0, -0.0]   # the branch points
    for fn in ("srgb_to_linear", "linear_to_srgb"):
        got, want = getattr(timage, fn)(v), getattr(jimage, fn)(v)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(timage.linear_to_srgb(timage.srgb_to_linear(v.clip(0, 1))),
                               v.clip(0, 1), atol=1e-5)


@pytest.mark.parametrize("ext,channels", [(".png", 3), (".png", 4), (".jpg", 3), (".bin", 3),
                                          (".bin", 4)])
def test_write_and_read_round_trip(tmp_path, ext, channels):
    rng = np.random.default_rng(channels)
    img = rng.uniform(0.05, 1.0, (24, 40, channels)).astype(np.float32)
    if ext == ".jpg":   # a smooth picture: JPEG's loss on noise is no property of the port
        img = timage.srgb_to_linear(timage.synthetic_image(24, 40))
    if channels == 4:   # linear colour premultiplied by alpha, as write_image takes it
        img[..., :3] *= img[..., 3:4]
    path, jpath = str(tmp_path / f"a{ext}"), str(tmp_path / f"j{ext}")
    timage.write_image(path, img)
    jimage.write_image(jpath, img)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        same = f.read() == g.read()
    back = timage.read_image(path)
    np.testing.assert_array_equal(back, jimage.read_image(jpath))
    if ext == ".bin":
        assert same and back.shape == (24, 40, 4)
        np.testing.assert_array_equal(back[..., :channels], img.astype(np.float16).astype(np.float32))
        return
    assert same   # the same bytes as the JAX package writes
    assert back.shape == img.shape
    if ext == ".jpg":   # JPEG's own loss, at quality 95 without chroma subsampling
        assert float(np.abs(back - img).mean()) <= 0.01
        return
    # 8-bit sRGB: half a step of 1/255 after the gamma, below two steps in linear
    assert float(np.abs(back - img).max()) <= 2.0 / 255.0


def test_load_image_and_bench_image(tmp_path, monkeypatch):
    from PIL import Image

    u8 = (np.random.default_rng(1).uniform(0, 1, (9, 13, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(u8).save(path)
    got = timage.load_image(path)
    np.testing.assert_array_equal(got, jimage.load_image(path))
    assert got.dtype == np.float32 and got.shape == (9, 13, 3)
    monkeypatch.setenv("TCNN_TPU_BENCH_IMAGE", path)
    img, name = timage.bench_image()
    assert name == "x.png" and img.shape == (9, 13, 3)
    monkeypatch.delenv("TCNN_TPU_BENCH_IMAGE")
    img, name = timage.bench_image()
    assert name == "fixture.png" and img.shape == (1024, 1024, 3)
    # the committed fixture is a render of synthetic_image(1024, 1024)
    assert float(np.abs(img[::64, ::64] - timage.synthetic_image(1024, 1024)[::64, ::64]).max()) \
        <= 1.0 / 255.0


# -- the image sample ----------------------------------------------------------


def test_image_sample_takes_a_few_steps(tmp_path, capsys):
    """The port's image sample on the CPU: 10 steps of config_hash on a
    64 × 64 picture through ``make_training_loop`` (eager there), its
    prints, PSNR at step 10 and the dump 10.jpg."""
    from PIL import Image

    pic = timage.synthetic_image(64, 64)
    path = str(tmp_path / "pic.png")
    Image.fromarray((pic * 255).astype(np.uint8)).save(path)
    cfg = os.path.join(REPO, "configs", "config_hash.json")
    out = timg.main(["x", path, cfg, "10"], device="cpu", out_dir=str(tmp_path), batch_pow=10)
    text = capsys.readouterr().out
    assert "Image: 64x64" in text and "Step#10: loss=" in text and "PSNR@10" in text
    assert os.path.exists(tmp_path / "10.jpg")
    losses = out["losses"]
    assert losses.shape == (10,) and bool(torch.isfinite(losses).all())
    assert float(losses[-3:].mean()) < float(losses[:3].mean())
    assert np.isfinite(out["psnr"]) and set(out["psnr_at"]) == {10}
