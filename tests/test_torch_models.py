"""Parity of pyp_tpu_torch/models (unet, io, picker) with the JAX package
on the CPU: the flax-convention layers at odd and even sizes, the U-Net
with carried weights, weight files crossing the packages for every
model, and the picker's functions one by one (the denoisers are in
test_torch_denoise.py).

Both packages start from the same weights: flax's `init`, carried into
the port by `models.io.from_flax` (`carried_init` patches the port's
initialiser, which every trainer calls). Batches are the same numpy
draws, so training is held step by step for three Adam steps.

Tolerances: layers and forwards with carried weights 1e-5 x max|output|
(float32 convolutions summed in another order); weight files equal to
the bit; after three training steps the trained networks' outputs within
1e-4 x max and the kernels within 1e-5 (a bias in front of a GroupNorm
has no gradient but float noise, which Adam's first steps scale to
+-lr, so biases are held through the outputs); heatmaps 1e-4 x max;
picks equal (coordinates and values, equal values in JAX's order).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu.models import io as jio
from pyp_tpu.models import picker as jpick
from pyp_tpu.models.unet import UNet2D as JUNet
from pyp_tpu_torch.models import io as tio
from pyp_tpu_torch.models import picker as tpick
from pyp_tpu_torch.models import unet as tunet
from tests.test_models import make_labeled_micrographs

CPU = "cpu"
FEATS = (4, 8)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def np_tree(p):
    return jax.tree.map(np.asarray, p)


def close(a, b, rel=1e-5):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-30))


def nchw(x):
    return torch.as_tensor(np.moveaxis(np.asarray(x), -1, 1).copy())


@contextlib.contextmanager
def carried_init(**by_class):
    """Make the port's trainers start from the given flax parameter trees,
    by module class name (other modules keep the port's initialiser)."""
    real = tunet.init_params

    def init(module, seed=0):
        tree = by_class.get(type(module).__name__)
        if tree is None:
            return real(module, seed)
        module.load_state_dict(tio.from_flax(np_tree(tree)))
        return module

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tunet, "init_params", init)
        yield


@functools.lru_cache(maxsize=None)
def unet_init(features, seed=0):
    """flax's U-Net init with PRNGKey(seed), as the JAX trainers draw it
    (the parameters do not depend on the input's size)."""
    return jax.jit(JUNet(features=features, out_channels=1).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 1)))


def port_unet(tree, features):
    net = tunet.UNet2D(features)
    net.load_state_dict(tio.from_flax(np_tree(tree)))
    return net.eval()


# ---------------------------------------------------------------- layers

LAYER_CASES = [(kind, nd, n, s, k)
               for kind in ("Conv", "ConvTranspose") for nd in (2, 3)
               for n in (7, 8) for s in (1, 2) for k in (3, 2)
               if not (nd == 3 and k == 2)]


@pytest.mark.parametrize("kind,nd,n,s,k", LAYER_CASES,
                         ids=[f"{c[0]}{c[1]}d-n{c[2]}-s{c[3]}-k{c[4]}"
                              for c in LAYER_CASES])
def test_flax_convention_layers(kind, nd, n, s, k):
    import flax.linen as fnn

    rng = np.random.RandomState(n + 10 * s + k)
    x = rng.randn(2, *(n,) * nd, 3).astype(np.float32)
    layer = getattr(fnn, kind)(4, (k,) * nd, strides=(s,) * nd)
    p = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(layer.apply(p, jnp.asarray(x)))
    port = getattr(tunet, kind)(3, 4, (k,) * nd, strides=s)
    sd = tio.from_flax({f"{kind}_0": np_tree(p["params"])})
    port.load_state_dict({key.split(".", 1)[1]: v for key, v in sd.items()})
    got = np.moveaxis(port(nchw(x)).detach().numpy(), 1, -1)
    close(got, want)


def test_group_norm_and_dense():
    import flax.linen as fnn

    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 6, 16).astype(np.float32) * 3 + 1
    for layer, port, inp in (
            (fnn.GroupNorm(num_groups=8), tunet.GroupNorm(8, 16), nchw(x)),
            (fnn.Dense(7), tunet.Dense(16, 7), torch.as_tensor(x))):
        p = np_tree(layer.init(jax.random.PRNGKey(2), jnp.asarray(x)))
        p = jax.tree.map(lambda a: a + rng.randn(*a.shape).astype(np.float32), p)
        name = type(layer).__name__
        sd = tio.from_flax({f"{name}_0": p["params"]})
        port.load_state_dict({key.split(".", 1)[1]: v for key, v in sd.items()})
        want = np.asarray(layer.apply(p, jnp.asarray(x)))
        got = port(inp).detach().numpy()
        close(np.moveaxis(got, 1, -1) if name == "GroupNorm" else got, want)


def test_init_draws_flax_statistics():
    """The port's initialiser: truncated-normal kernels at flax's fan-in
    scale, zero biases, unit GroupNorm scales; seeded and repeatable."""
    a = tunet.init_params(tunet.UNet2D((16, 32)), 3)
    b = tunet.init_params(tunet.UNet2D((16, 32)), 3)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb)
    k = a.ConvBlock_1.Conv_1.kernel                     # fan-in 32 * 9
    std = (1.0 / (32 * 9)) ** 0.5
    k = k.detach()
    assert abs(float(k.std()) / std - 1) < 0.05
    assert float(k.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert float(a.ConvBlock_1.Conv_1.bias.detach().abs().max()) == 0.0
    assert float(a.ConvBlock_1.GroupNorm_0.scale.detach().min()) == 1.0


@pytest.mark.parametrize("features,size", [((4, 8), 16), ((4, 8, 16), 20)])
def test_unet_forward_with_carried_weights(features, size):
    x = np.random.RandomState(4).randn(2, size, size, 1).astype(np.float32)
    p = unet_init(features)
    want = np.asarray(jax.jit(JUNet(features=features).apply)(
        p, jnp.asarray(x)))
    got = port_unet(p, features)(nchw(x)).detach().numpy()
    close(np.moveaxis(got, 1, -1), want)


# ---------------------------------------------------------------- weight files

def _model_cases():
    """name -> (flax module, input shape, port module) for every model
    of the package."""
    from pyp_tpu.models.heterogeneity import Encoder, SliceDecoder
    from pyp_tpu.models.miner import Encoder3D
    from pyp_tpu.models.quality import QualityAE
    from pyp_tpu_torch.models import heterogeneity as th
    from pyp_tpu_torch.models import miner as tm
    from pyp_tpu_torch.models import quality as tq

    return {
        "unet": (JUNet(features=(4, 8, 16)), (2, 16, 16, 1),
                 tunet.UNet2D((4, 8, 16))),
        "membrane": (JUNet(features=(4, 8)), (2, 12, 12, 1),
                     tunet.UNet2D((4, 8))),
        "encoder3d": (Encoder3D(features=(4, 8), embed_dim=6),
                      (2, 9, 8, 8, 1), tm.Encoder3D((4, 8), 6)),
        "quality": (QualityAE(latent_dim=5), (2, 13, 13, 2),
                    tq.QualityAE(5, 13)),
        "het_encoder": (Encoder(latent_dim=3), (2, 12, 12, 1),
                        th.Encoder(3, 12)),
    }


@functools.lru_cache(maxsize=None)
def _flax_case(name):
    """The flax model `name` with trained-looking weights (every leaf
    moved off its initial value), an input and its outputs."""
    jm, shape, _ = _model_cases()[name]
    rng = np.random.RandomState(5)
    x = rng.randn(*shape).astype(np.float32)
    p = np_tree(jax.jit(jm.init)(jax.random.PRNGKey(7), jnp.asarray(x)))
    p = jax.tree.map(lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32), p)
    want = jax.jit(jm.apply)(p, jnp.asarray(x))
    want = want if isinstance(want, tuple) else (want,)
    return p, x, [np.asarray(w) for w in want]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", ["unet", "membrane", "encoder3d", "quality",
                                  "het_encoder"])
def test_weight_files_cross_and_compute_the_same(name, writer, tmp_path):
    p, x, want = _flax_case(name)
    tm = _model_cases()[name][2]
    path = tmp_path / "w.npz"
    if writer == "jax":
        jio.save_params(p, path, patch=16)
        sd, meta = tio.load_params(path, tm)
        tm.load_state_dict(sd)
    else:
        tm.load_state_dict(tio.from_flax(p))
        tio.save_params(tm, path, patch=16)
        jio.save_params(p, tmp_path / "j.npz", patch=16)
        a, b = np.load(path), np.load(tmp_path / "j.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        back, meta = jio.load_params(path, p)
        for u, v in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
            np.testing.assert_array_equal(u, v)
    assert int(meta["patch"]) == 16
    got = tm.eval()(nchw(x))
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        g = g.detach().numpy()
        close(np.moveaxis(g, 1, -1) if g.ndim > 2 else g, w)


def test_tuple_weight_file_crosses(tmp_path):
    """The heterogeneity model's (encoder, decoder) pair: one file, the
    same bytes from either package."""
    from pyp_tpu.models.heterogeneity import Encoder, SliceDecoder
    from pyp_tpu_torch.models import heterogeneity as th

    ep = jax.jit(Encoder(latent_dim=3).init)(jax.random.PRNGKey(1),
                                             jnp.zeros((1, 12, 12, 1)))
    dp = jax.jit(SliceDecoder(latent_dim=3, hidden=16).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 5, 3)), jnp.zeros((1, 5, 3)))
    jio.save_params((ep, dp), tmp_path / "j.npz", n=12)
    pair = (tio.from_flax(np_tree(ep)), tio.from_flax(np_tree(dp)))
    tio.save_params(pair, tmp_path / "t.npz", n=12)
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[k], b[k]) for k in a.files)
    like = (th.Encoder(3, 12).state_dict(),
            th.SliceDecoder(3, 16).state_dict())
    (e, d), _ = tio.load_params(tmp_path / "j.npz", like)
    for got, want in zip((e, d), pair):
        assert all(torch.equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------- picker

@pytest.fixture(scope="module")
def labeled():
    mics, coords = make_labeled_micrographs(n_mics=2, n=64, n_particles=3,
                                            radius=4)
    return [m.astype(np.float32) for m in mics], coords


def test_heatmap_and_patches_are_exact(labeled):
    mics, coords = labeled
    heats = [jpick.make_heatmap(m.shape, c, 4) for m, c in zip(mics, coords)]
    for h, m, c in zip(heats, mics, coords):
        np.testing.assert_array_equal(tpick.make_heatmap(m.shape, c, 4), h)
    jx, jy = jpick._sample_patches(mics, heats, 32, 5,
                                   np.random.RandomState(3))
    tx, ty = tpick._sample_patches(mics, heats, 32, 5,
                                   np.random.RandomState(3))
    np.testing.assert_array_equal(np.moveaxis(tx, 1, -1), np.asarray(jx))
    np.testing.assert_array_equal(np.moveaxis(ty, 1, -1), np.asarray(jy))


@pytest.fixture(scope="module")
def picker_pair(labeled):
    mics, coords = labeled
    kw = dict(radius_px=4, patch=32, steps=3, batch=4, features=FEATS)
    jm = jpick.train_picker(mics, coords, **kw)
    with carried_init(UNet2D=unet_init(FEATS)):
        tm = tpick.train_picker(mics, coords, device=CPU, **kw)
    return jm, tm


def test_train_picker_three_steps(picker_pair, labeled):
    jm, tm = picker_pair
    want = tio.from_flax(np_tree(jm.params))
    for k, v in want.items():
        if k.endswith("kernel"):
            close(tm.params[k], v.numpy(), rel=1e-4)
    x = labeled[0][0][None, :32, :32, None]
    jout = JUNet(features=FEATS).apply(jm.params, jnp.asarray(x))
    net = tunet.UNet2D(FEATS)
    net.load_state_dict(tm.params)
    close(np.moveaxis(net(nchw(x)).detach().numpy(), 1, -1),
          np.asarray(jout), rel=1e-4)
    assert tm.patch == jm.patch == 32


@pytest.mark.parametrize("shape", [(64, 64), (80, 72), (24, 80)])
def test_infer_heatmap_batched_matches_the_tile_loop(picker_pair, shape):
    jm, _ = picker_pair
    mic = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    want = jpick.infer_heatmap(jm, mic, features=FEATS)
    model = tpick.PickerModel(tio.from_flax(np_tree(jm.params)), 32, 4)
    got = tpick.infer_heatmap(model, mic, features=FEATS, device=CPU)
    close(got, want, rel=1e-4)


def test_pick_from_heatmap_is_exact_with_ties():
    rng = np.random.RandomState(6)
    heat = (np.round(rng.rand(40, 36) * 6) / 6).astype(np.float32)
    heat[10:13, 10:13] = 0.9          # a plateau: nine equal maxima
    for radius, thr, k in ((1, 0.3, 64), (3, 0.5, 20)):
        jc, jv, jok = jpick.pick_from_heatmap(heat, radius, thr, k)
        tc, tv, tok = tpick.pick_from_heatmap(heat, radius, thr, k, device=CPU)
        np.testing.assert_array_equal(tok.numpy(), jok)
        np.testing.assert_array_equal(tc.numpy()[jok], jc[jok])
        np.testing.assert_array_equal(tv.numpy(), jv)


def test_pick_tomogram():
    """With the default widths (as the JAX function has them) and carried
    weights."""
    p = unet_init((16, 32, 64), seed=2)
    vol = np.random.RandomState(7).randn(3, 32, 36).astype(np.float32)
    jm = jpick.PickerModel(params=p, patch=32, radius_px=3)
    tm = tpick.PickerModel(tio.from_flax(np_tree(p)), 32, 3)
    jc, jv, jok = jpick.pick_tomogram(jm, vol, 3, threshold=0.0, max_picks=6)
    tc, tv, tok = tpick.pick_tomogram(tm, vol, 3, threshold=0.0, max_picks=6,
                                      device=CPU)
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_array_equal(tc.numpy()[jok], jc[jok])
    close(tv[tok], jv[jok], rel=1e-5)


def test_heatmap_on_the_device_matches(labeled):
    """The trainer's heatmaps, made on the device, are make_heatmap's to
    float64 rounding."""
    mics, coords = labeled
    for m, c in zip(mics, coords):
        np.testing.assert_allclose(
            tpick._heatmap_on(m.shape, c, 4, "cpu").numpy(),
            jpick.make_heatmap(m.shape, c, 4), rtol=1e-12, atol=1e-300)
