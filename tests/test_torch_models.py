"""The bundled segmentation predictors (semantic_meshes_torch.models.
segmentation) against the JAX package's flax models on the same inputs.

Mirrors every predictor test of tests/test_models.py (the port on the
CPU, its bounds unchanged) and adds parity: the resize helpers equal
jax.image.resize to 1e-6; ConvBlock, UNet, PSPNet and RGBDUNet from one
flax init carried across by convert.segmentation_params give the JAX
model's logits and probabilities; the loaders, `sliding` and
`multi_scale` over the same carried params give JAX's probabilities;
the port's init has flax's per-layer statistics; and weights trained by
the JAX package's SegmentationTrainer make sliding beat a single pass in
the port as they do in JAX.

The tolerances and their reasons are in tests/_torch_models.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semantic_meshes.models import segmentation as jseg
from semantic_meshes_torch import convert
from semantic_meshes_torch.models import segmentation
from _torch_models import (ARGMAX_SHARE, LOGIT_RTOL, PROB_MEAN,
                           assert_probs_close)

CPU = "cpu"
RESIZE_ATOL = 1e-6


def _image(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 256, shape).astype(np.uint8)


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------- mirrors of test_models.py

def test_unet_predictor_shapes_and_softmax():
    predict = segmentation.load_predictor(
        classes=7, input_hw=(64, 64), widths=(16, 32, 64), device=CPU)
    probs = _np(predict(_image((50, 70, 3), 0)))
    assert probs.shape == (50, 70, 7)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-3)
    assert (probs >= 0).all()


def test_unet_grayscale_and_rgba():
    predict = segmentation.load_predictor(
        classes=4, input_hw=(32, 32), widths=(8, 16, 32), device=CPU)
    assert tuple(predict(np.zeros((40, 40), np.uint8)).shape) == (40, 40, 4)
    assert tuple(predict(np.zeros((40, 40, 4), np.uint8)).shape) == (
        40, 40, 4)


def test_rgbd_predictor():
    predict = segmentation.load_rgbd_predictor(
        classes=5, input_hw=(32, 32), widths=(8, 16, 32), device=CPU)
    rng = np.random.default_rng(1)
    color = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    depth = rng.integers(0, 5000, (24, 32)).astype(np.uint16)  # lower res
    probs = _np(predict(color, depth))
    assert probs.shape == (48, 64, 5)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-3)


def test_pspnet_predictor():
    predict = segmentation.load_predictor(
        classes=6, input_hw=(64, 64), widths=(8, 16, 32, 32), arch="pspnet",
        device=CPU)
    probs = _np(predict(np.zeros((48, 80, 3), np.uint8)))
    assert probs.shape == (48, 80, 6)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-3)


class TestSlidingMultiScale:
    def test_window_starts_cover_and_overlap(self):
        starts = segmentation._window_starts(100, 40, 0.2)
        assert starts[0] == 0 and starts[-1] == 60
        assert all(b - a <= 40 for a, b in zip(starts, starts[1:]))
        assert segmentation._window_starts(30, 40, 0.2) == [0]

    def test_sliding_passthrough_below_window(self):
        base = segmentation.load_predictor(
            classes=4, input_hw=(32, 32), widths=(8, 16, 32), device=CPU)
        slid = segmentation.sliding(base, (64, 64))
        img = _image((40, 48, 3), 0)
        assert torch.equal(slid(img), base(img))

    def test_sliding_shapes_softmax_and_batched_equals_fallback(self):
        predict = segmentation.load_predictor(
            classes=5, input_hw=(32, 32), widths=(8, 16, 32), device=CPU)
        img = _image((70, 90, 3), 1)
        slid = segmentation.sliding(predict, (32, 32), overlap=0.25)
        probs = _np(slid(img))
        assert probs.shape == (70, 90, 5)
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-3)

        def unbatched(image):
            return predict(image)

        unbatched.params = predict.params
        slow = segmentation.sliding(unbatched, (32, 32), overlap=0.25)
        # float32 on the CPU: the batched (N windows) and per-window (N=1)
        # passes agree to the test_models.py bound
        np.testing.assert_allclose(probs, _np(slow(img)), atol=1e-5)

    def test_multi_scale_identity_and_average(self):
        base = segmentation.load_predictor(
            classes=4, input_hw=(32, 32), widths=(8, 16, 32), device=CPU)
        img = _image((40, 40, 3), 2)
        ms1 = segmentation.multi_scale(base, [1.0])
        np.testing.assert_allclose(_np(ms1(img)), _np(base(img)), atol=1e-6)
        probs = _np(segmentation.multi_scale(base, [0.5, 1.0])(img))
        assert probs.shape == (40, 40, 4)
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-3)

    def test_loader_kwargs_compose(self):
        predict = segmentation.load_predictor(
            classes=3, input_hw=(32, 32), widths=(8, 16),
            sliding=(32, 32), multi_scale=[0.75, 1.0], device=CPU)
        probs = _np(predict(_image((64, 48, 3), 3)))
        assert probs.shape == (64, 48, 3)
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-3)
        assert tuple(predict(np.zeros((64, 48), np.uint8)).shape) == (
            64, 48, 3)

    def test_rgbd_loader_sliding(self):
        predict = segmentation.load_rgbd_predictor(
            classes=5, input_hw=(32, 32), widths=(8, 16, 32),
            sliding=(32, 32), device=CPU)
        rng = np.random.default_rng(4)
        color = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
        depth = rng.integers(0, 5000, (24, 32)).astype(np.uint16)
        probs = _np(predict(color, depth))
        assert probs.shape == (48, 64, 5)
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-3)

    def test_sliding_beats_single_pass_on_fine_detail(self, trained):
        """test_models.py's parity point of sliding inference, with the
        JAX package's SegmentationTrainer weights carried across: a model
        trained at 32x32 loses a fine checkerboard when a 128x128 image
        is squeezed through one pass and recovers it through native
        windows, in the port as in JAX."""
        params, big, lab = trained
        single = segmentation.load_predictor(
            classes=2, input_hw=(32, 32), widths=(8, 16), params=params,
            device=CPU)
        slid = segmentation.sliding(single, (32, 32), overlap=0.0)

        def accuracy(predict):
            return (_np(predict(big)).argmax(-1) == lab).mean()

        acc_single, acc_sliding = accuracy(single), accuracy(slid)
        assert acc_sliding > acc_single + 0.1, (acc_sliding, acc_single)
        assert acc_sliding > 0.9
        # and the JAX predictor on the same weights agrees
        jslid = jseg.sliding(jseg.load_predictor(
            classes=2, input_hw=(32, 32), widths=(8, 16), params=params),
            (32, 32), overlap=0.0)
        jpred = np.asarray(jslid(big)).argmax(-1)
        assert (_np(slid(big)).argmax(-1) == jpred).mean() >= ARGMAX_SHARE


@pytest.fixture(scope="module")
def trained():
    """test_models.py's 60 AdamW steps of a 2-class UNet(8, 16) on 32x32
    checkerboard / flat tiles, and its 128x128 composite."""
    from semantic_meshes.models import training

    rng = np.random.default_rng(5)

    def make_tile(flat):
        if flat:
            img = np.full((32, 32, 3), 160, np.float32)
            lab = np.zeros((32, 32), np.int32)
        else:
            yy, xx = np.mgrid[:32, :32]
            img = np.where(((yy + xx) % 2)[..., None] == 0, 220.0,
                           90.0).astype(np.float32) * np.ones(
                               (1, 1, 3), np.float32)
            lab = np.ones((32, 32), np.int32)
        img = img + rng.normal(0, 4, img.shape).astype(np.float32)
        return img, lab

    trainer = training.SegmentationTrainer(
        classes=2, input_hw=(32, 32), widths=(8, 16), learning_rate=3e-3)
    for _ in range(60):
        tiles = [make_tile(bool(rng.integers(0, 2))) for _ in range(8)]
        trainer.train_step({
            "image": jnp.asarray(np.stack([t[0] for t in tiles])) / 255.0,
            "labels": jnp.asarray(np.stack([t[1] for t in tiles])),
        })
    big = np.full((128, 128, 3), 160, np.float32)
    lab = np.zeros((128, 128), np.int32)
    yy, xx = np.mgrid[:64, :64]
    big[32:96, 32:96] = np.where(((yy + xx) % 2)[..., None] == 0, 220.0,
                                 90.0)
    lab[32:96, 32:96] = 1
    big = np.clip(big + rng.normal(0, 4, big.shape), 0, 255).astype(np.uint8)
    return jax.tree_util.tree_map(np.asarray, trainer.params), big, lab


@pytest.mark.parametrize("arch", ["unet", "rgbd"])
def test_params_path_in_both_packages(tmp_path, trained, arch):
    """A flax msgpack file (flax.serialization.to_bytes) loads in both
    packages' loaders and gives the same probabilities within the bounds:
    the trained UNet's weights, and an RGBDUNet's init. The JAX loader
    reads a file into a template from an eager flax init (compiled op by
    op), so the shapes follow the trained fixture's, whose eager init
    compiled most of those ops already."""
    from flax import serialization as flax_serialization

    widths = (8, 16)
    if arch == "unet":
        params, big, _ = trained
        inputs = (big[40:88, 20:76],)
    else:
        params = _init(jseg.RGBDUNet(classes=2, widths=widths), 8,
                       jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 1)))
        rng = np.random.default_rng(15)
        inputs = (rng.integers(0, 256, (40, 36, 3)).astype(np.uint8),
                  rng.integers(0, 5000, (20, 18)).astype(np.uint16))
    path = tmp_path / "params.msgpack"
    path.write_bytes(flax_serialization.to_bytes(params))
    kw = dict(classes=2, input_hw=(32, 32), widths=widths)
    jload, load = ((jseg.load_predictor, segmentation.load_predictor)
                   if arch == "unet" else (jseg.load_rgbd_predictor,
                                           segmentation.load_rgbd_predictor))
    want = np.asarray(jload(**kw, params_path=str(path))(*inputs))
    got = load(**kw, params_path=str(path), device=CPU)(*inputs)
    assert_probs_close(_np(got), want)
    # the file gives the port what the tree gives it, exactly
    assert torch.equal(got, load(**kw, params=params, device=CPU)(*inputs))


class TestPredictorInputHandling:
    def test_batch_accepts_gray_and_rgba(self):
        predict = segmentation.load_predictor(
            classes=4, input_hw=(32, 32), widths=(8, 16), device=CPU)
        for shape in ((2, 40, 40), (2, 40, 40, 4), (2, 40, 40, 1)):
            assert tuple(predict.batch(np.zeros(shape, np.uint8)).shape) == (
                2, 40, 40, 4)

    def test_sliding_gray_input_through_batch_path(self):
        predict = segmentation.load_predictor(
            classes=3, input_hw=(32, 32), widths=(8, 16), device=CPU)
        slid = segmentation.sliding(predict, (32, 32), overlap=0.25)
        probs = _np(slid(_image((64, 80), 6)))
        assert probs.shape == (64, 80, 3)
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-3)

    @pytest.mark.parametrize("size,win,overlap", [
        (100, 40, 0.2), (97, 33, 0.33), (512, 100, 0.15), (64, 63, 0.5)])
    def test_window_stride_honors_overlap(self, size, win, overlap):
        starts = segmentation._window_starts(size, win, overlap)
        assert starts[0] == 0 and starts[-1] == size - win
        for a, b in zip(starts, starts[1:]):
            assert (win - (b - a)) / win >= overlap - 1e-9, (a, b)

    def test_params_and_params_path_exclusive(self, tmp_path):
        p = tmp_path / "params.msgpack"
        p.write_bytes(b"")
        dummy = {"w": np.zeros(3)}
        with pytest.raises(ValueError, match="not both"):
            segmentation.load_predictor(
                classes=3, input_hw=(32, 32), widths=(8, 16), params=dummy,
                params_path=str(p), device=CPU)
        with pytest.raises(ValueError, match="not both"):
            segmentation.load_rgbd_predictor(
                classes=3, input_hw=(32, 32), widths=(8, 16), params=dummy,
                params_path=str(p), device=CPU)


# ------------------------------------------------------------- parity: resize

@pytest.mark.parametrize("src,dst", [
    ((97, 131), (48, 64)),  # shrink: antialiased
    ((60, 80), (121, 163)),  # grow at a fractional scale
    ((48, 64), (97, 31)),  # one axis grows, the other shrinks
    ((33, 64), (77, 64)),  # one axis only
    ((40, 40), (80, 80)),  # 2x
    # ScanNet's depth to colour: at sample ~600 a float32 rounding of
    # (j + 0.5) * in / out - 0.5 more than XLA's fused multiply-add moves
    # a weight by 6e-5 (segmentation._bilinear_weights)
    ((480, 640), (968, 1296)),
])
def test_bilinear_resize_matches_jax(src, dst):
    x = np.random.default_rng(7).random((2,) + src + (3,), dtype=np.float32)
    want = np.asarray(jax.image.resize(x, (2,) + dst + (3,), "bilinear"))
    got = _np(segmentation.resize(torch.from_numpy(x), dst))
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)
    # the image form resizes the first two axes, any trailing ones kept
    img = x[0, ..., :2]
    want = np.asarray(jseg._resize_bilinear(img, dst))
    got = _np(segmentation._resize_bilinear(torch.from_numpy(img), dst))
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_nearest_2x_equals_jax_bit_for_bit():
    x = np.random.default_rng(8).random((2, 13, 21, 5), dtype=np.float32)
    want = np.asarray(jax.image.resize(x, (2, 26, 42, 5), "nearest"))
    got = _np(segmentation.resize(torch.from_numpy(x), (26, 42), "nearest"))
    np.testing.assert_array_equal(got, want)


def test_nearest_differs_from_jitted_jax_only_on_exact_boundaries():
    """The port samples floor((i + 0.5) * in / out) exactly. Jitted XLA
    rounds the division differently, so where (i + 0.5) * in / out is an
    integer (a sample on a cell boundary) JAX may take the cell below;
    everywhere else the two are equal. The models resize by 2x only,
    where no sample lies on a boundary."""
    m, n = 80, 163
    x = np.arange(m, dtype=np.float32).reshape(1, m, 1, 1)
    want = np.asarray(jax.image.resize(x, (1, n, 1, 1), "nearest")).ravel()
    got = _np(segmentation.resize(torch.from_numpy(x), (n, 1),
                                  "nearest")).ravel()
    exact = (np.arange(n) * 2 + 1) * m % (2 * n) == 0
    assert (got != want).any()
    assert exact[got != want].all()
    np.testing.assert_array_equal(got[~exact], want[~exact])
    np.testing.assert_array_equal(
        got, np.floor((np.arange(n) + 0.5) * m / n))


# ------------------------------------------------------- parity: the models

def _init(model, seed, *args):
    """flax init, jitted (eager init compiles every op on its own: ~25 s
    for a 3-level UNet), as numpy leaves."""
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), *args)
    return jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _flax_params(arch):
    """One flax init per architecture (5 classes), shared by the tests;
    the parameter shapes do not depend on the input's size."""
    cls, widths, bhw = ARCH_CASES[arch]
    return _init(cls(classes=5, widths=widths), 3,
                 *_inputs(arch, (1,) + bhw[1:]))


def _carry(jparams, arch, widths):
    return convert.segmentation_params(
        jax.tree_util.tree_map(np.asarray, jparams), arch, widths)


ARCH_CASES = {
    "unet": (jseg.UNet, (8, 16, 32), (2, 32, 48)),
    "pspnet": (jseg.PSPNet, (8, 16, 32, 32), (2, 64, 64)),
    "rgbd": (jseg.RGBDUNet, (8, 16, 32), (2, 32, 32)),
}


def _inputs(arch, bhw, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.random(bhw + (3,), dtype=np.float32)
    if arch == "rgbd":
        return x, (rng.random(bhw + (1,), dtype=np.float32) * 4.0)
    return (x,)


@pytest.fixture(scope="module", params=list(ARCH_CASES))
def carried(request):
    """(arch, widths, flax params, port model, inputs, JAX logits)."""
    arch = request.param
    cls, widths, bhw = ARCH_CASES[arch]
    model = cls(classes=5, widths=widths)
    args = _inputs(arch, bhw)
    # nonzero biases and GroupNorm scales, so every leaf's conversion shows
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v if path[-1].key == "kernel" else v + rng.normal(
            0, 0.1, v.shape).astype(np.float32), _flax_params(arch))
    logits = np.asarray(jax.jit(model.apply)(params, *args))
    port = segmentation.ARCHS[arch](classes=5, widths=widths)
    port.load_state_dict(_carry(params, arch, widths))
    return arch, widths, params, port.eval(), args, logits


def test_models_match_jax_from_carried_params(carried):
    arch, widths, _, port, args, want = carried
    with torch.no_grad():
        got = _np(port(*(torch.from_numpy(a) for a in args)))
    assert got.shape == want.shape == args[0].shape[:3] + (5,)
    assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()
    assert_probs_close(_np(torch.softmax(torch.from_numpy(got), -1)),
                       np.asarray(jax.nn.softmax(want, -1)))


def test_carried_keys_are_flax_paths(carried):
    arch, widths, params, port, _, _ = carried
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    paths = {".".join(k.key for k in path) for path, _ in flat}
    rename = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    want = {p.rsplit(".", 1)[0] + "." + rename[p.rsplit(".", 1)[1]]
            for p in paths}
    assert set(port.state_dict()) == want
    # every leaf carried exactly: kernels (kh, kw, in, out) -> (out, in,
    # kh, kw), the rest as they are
    state = port.state_dict()
    for (path, value) in flat:
        *mod, leaf = [k.key for k in path]
        got = state[".".join(mod) + "." + rename[leaf]].numpy()
        want_v = np.asarray(value)
        if leaf == "kernel":
            want_v = want_v.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(got, want_v)
    # a missing or an extra key raises
    tree = jax.tree_util.tree_map(np.asarray, params)
    inner = dict(tree["params"])
    inner.pop(sorted(inner)[0])
    with pytest.raises(KeyError, match="missing"):
        convert.segmentation_params({"params": inner}, arch, widths)
    inner = dict(tree["params"], Conv_99={"kernel": np.zeros((1, 1, 1, 1)),
                                          "bias": np.zeros(1)})
    with pytest.raises(KeyError, match="not in the model"):
        convert.segmentation_params({"params": inner}, arch, widths)


def test_conv_block_matches_jax():
    x = np.random.default_rng(10).random((1, 24, 20, 12), dtype=np.float32)
    block = jseg.ConvBlock(16)
    params = _init(block, 4, x)
    want = np.asarray(jax.jit(block.apply)(params, x))
    port = segmentation.ConvBlock(12, 16)
    port.load_state_dict(_block_state(params["params"]))
    with torch.no_grad():
        got = _np(segmentation._to_nhwc(port(segmentation._to_nchw(
            torch.from_numpy(x)))))
    assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()
    assert np.abs(got - want).mean() <= PROB_MEAN


def _block_state(tree):
    out = {}
    for name, leaves in tree.items():
        for leaf, v in leaves.items():
            t = torch.from_numpy(np.array(v))
            if leaf == "kernel":
                out[f"{name}.weight"] = t.permute(3, 2, 0, 1)
            else:
                out[f"{name}.{'weight' if leaf == 'scale' else 'bias'}"] = t
    return out


@pytest.mark.parametrize("channels,hw", [(64, (12, 20)), (16, (7, 9)),
                                         (8, (1, 5))])
def test_group_norm_channels_last_equals_nchw(channels, hw):
    """GroupNorm reduces a channels_last input in place (var_mean over
    pixels and the group's channels); an NCHW input gives the same bits,
    and both equal PyTorch's group_norm of the same values to float32
    rounding."""
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.normal(
        1.0, 2.0, (2, channels) + hw).astype(np.float32))
    norm = segmentation.GroupNorm(channels)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(rng.normal(
            1, 0.1, channels).astype(np.float32)))
        norm.bias.copy_(torch.from_numpy(rng.normal(
            0, 0.1, channels).astype(np.float32)))
        want = torch.nn.functional.group_norm(x, min(32, channels),
                                              norm.weight, norm.bias, 1e-6)
        got = norm(x.contiguous(memory_format=torch.channels_last))
        assert torch.equal(norm(x), got)
    assert got.is_contiguous(memory_format=torch.channels_last) or hw[0] == 1
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=2e-6 * float(want.abs().max()))


@pytest.mark.parametrize("channels", [64, 16])
def test_group_norm_gelu_equals_flax_in_float32(channels):
    """A ConvBlock stage's float32 tail, GroupNorm then GELU, against
    flax's nn.GroupNorm(num_groups=min(32, C)) and nn.gelu, exactly up to
    float32 rounding. The input's std of 0.02 makes eps show: PyTorch's
    1e-5 in place of flax's 1e-6 moves the output by ~1%, and GELU's erf
    form in place of the tanh form by up to ~1e-3."""
    import flax.linen as fnn

    rng = np.random.default_rng(17)
    x = rng.normal(0.0, 0.02, (2, 6, 8, channels)).astype(np.float32)
    scale = rng.normal(1.0, 0.1, channels).astype(np.float32)
    bias = rng.normal(0.0, 0.1, channels).astype(np.float32)
    norm = fnn.GroupNorm(num_groups=min(32, channels))
    want = np.asarray(fnn.gelu(norm.apply(
        {"params": {"scale": scale, "bias": bias}}, x)))
    port = segmentation.GroupNorm(channels)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        got = _np(segmentation._to_nhwc(segmentation.norm_gelu(
            port, segmentation._to_nchw(torch.from_numpy(x)))))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_init_matches_flax_statistics():
    """lecun_normal: every kernel's std is 1/sqrt(fan_in) (truncated normal
    rescaled), no value past 2 / 0.8796 of it; biases 0, GroupNorm scale
    1. Flax's init and the port's both within 12% of that std per layer
    (the smallest layer has 432 values: a 3.4% standard error)."""
    widths = (16, 32, 64)
    jparams = _init(jseg.UNet(classes=8, widths=widths), 0,
                    jnp.zeros((1, 8, 8, 3)))
    port = segmentation.init_(segmentation.UNet(classes=8, widths=widths), 0)
    jstate = _carry(jparams, "unet", widths)
    sd = port.state_dict()
    assert set(sd) == set(jstate)
    n_kernels = 0
    for key, value in sd.items():
        if key.endswith(".weight") and value.ndim == 4:
            n_kernels += 1
            std = 1.0 / np.sqrt(value[0].numel())
            for w in (value, jstate[key]):
                assert abs(float(w.std()) / std - 1.0) < 0.12, key
                assert float(w.abs().max()) <= 2 * std / 0.87962566 + 1e-6
        else:
            want = 1.0 if ".GroupNorm_" in key and key.endswith(
                ".weight") else 0.0
            assert torch.equal(value, torch.full_like(value, want)), key
            assert torch.equal(jstate[key], value), key
    assert n_kernels == 2 * 5 + 2 + 1  # 5 blocks, 2 decoder 1x1s, head
    again = segmentation.init_(segmentation.UNet(classes=8, widths=widths),
                               0).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


# --------------------------------------------------- parity: the predictors

def test_window_starts_equal_jax():
    for size in (1, 31, 32, 33, 64, 97, 512, 1024, 2048):
        for win in (16, 32, 63, 512, 713):
            for overlap in (0.0, 0.2, 0.25, 0.5):
                assert segmentation._window_starts(size, win, overlap) == \
                    jseg._window_starts(size, win, overlap)


def test_predictor_sliding_and_multi_scale_match_jax():
    """load_predictor (resize in, softmax, resize out), and sliding and
    multi_scale composed as the loader composes them (a grayscale image),
    over one set of flax params handed to both packages (the port
    converts the tree)."""
    widths = ARCH_CASES["unet"][1]
    kw = dict(classes=5, input_hw=(32, 32), widths=widths,
              params=_flax_params("unet"))
    for extra, img in (({}, _image((64, 48, 3), 11)),
                       (dict(sliding=(32, 32), multi_scale=[0.75, 1.0]),
                        _image((64, 48), 12))):
        want = np.asarray(jseg.load_predictor(**kw, **extra)(img))
        got = _np(segmentation.load_predictor(**kw, **extra,
                                              device=CPU)(img))
        assert_probs_close(got, want)


def test_rgbd_predictor_matches_jax():
    widths = ARCH_CASES["rgbd"][1]
    params = _flax_params("rgbd")
    rng = np.random.default_rng(13)
    color = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    depth = rng.integers(0, 5000, (24, 32)).astype(np.uint16)
    kw = dict(classes=5, input_hw=(32, 32), widths=widths, params=params,
              sliding=(32, 32))
    want = np.asarray(jseg.load_rgbd_predictor(**kw)(color, depth))
    got = _np(segmentation.load_rgbd_predictor(**kw, device=CPU)(color,
                                                                 depth))
    assert_probs_close(got, want)


def test_state_dict_params_and_attributes():
    """params= takes the port's state_dict as well as the JAX tree;
    .params / .model / .base ride through the combinators, and .batch
    only exists without them."""
    params, widths = _flax_params("unet"), ARCH_CASES["unet"][1]
    kw = dict(classes=5, input_hw=(32, 32), widths=widths, device=CPU)
    a = segmentation.load_predictor(**kw, params=params)
    b = segmentation.load_predictor(**kw, params=a.params)
    img = _image((40, 36, 3), 14)
    assert torch.equal(a(img), b(img))
    assert hasattr(a, "batch") and isinstance(a.model, segmentation.UNet)
    c = segmentation.load_predictor(**kw, params=params, sliding=(32, 32))
    assert not hasattr(c, "batch") and c.model is not None
    s = segmentation.sliding(a, (16, 16))
    assert s.base is a and s.model is a.model and s.params is a.params
    seeded = [segmentation.load_predictor(**kw, seed=s)(img)
              for s in (0, 0, 1)]
    assert torch.equal(seeded[0], seeded[1])
    assert not torch.equal(seeded[0], seeded[2])
