"""The bundled 2D semantic-segmentation predictors, on PyTorch.

Counterpart of the JAX package's `semantic_meshes/models/segmentation.py`
(flax): the same UNet, PSPNet and RGBDUNet, the same resizes, the same
`sliding` and `multi_scale` combinators and the same loaders, with the
flax numerics kept where PyTorch's defaults differ:

- 3x3 and 1x1 convolutions in bfloat16 (input, kernel and bias cast;
  bf16 output, rounded before the bias add as flax adds it), cast to
  float32 before GroupNorm and before the decoder's concat; the
  classifier head in float32, with cuDNN's TF32 turned off around it;
- GroupNorm over min(32, C) groups with eps 1e-6 (flax's), in float32;
- GELU in its tanh form (flax's `nn.gelu` default);
- pooling with VALID (floor) windows;
- `jax.image.resize(..., "bilinear")` as JAX computes it (it
  antialiases where an axis shrinks): each axis contracted with the same
  float32 weight matrix (`_bilinear_weights`); `"nearest"` samples
  floor((i + 0.5) * in / out);
- initialisation as flax's: lecun_normal kernels (truncated normal,
  fan-in, variance 1), zero biases, GroupNorm scale 1 and bias 0, drawn
  from a `torch.Generator` (not the JAX package's PRNGKey bits).

Layouts stay the JAX package's at every public function: images and
probabilities are (..., H, W, C); a model takes (B, H, W, C) and returns
(B, H, W, classes) logits, and works NCHW inside, in channels_last.
Submodules carry flax's auto-names in call order (`ConvBlock_0`,
`Conv_0`, `GroupNorm_0`, ...), so a `state_dict` key is a flax parameter
path (`convert.segmentation_params` carries one across). These layers
are PyTorch calls (cuDNN convolutions, GroupNorm, pooling, resizes), as
they are XLA in the JAX package: no Pallas kernel lies on this path.

`load_predictor` returns `image (H, W[, 3|4]) uint8 -> probs (H, W,
classes)` float32 softmax on the predictor's device; `load_rgbd_predictor`
`(color, depth) -> probs`. Both default to `device="cuda"` and raise
without a card; weights come from `params=` (the port's state_dict, or
the JAX package's parameter tree), from a flax msgpack file
(`params_path=`, read by `serialization.load_flax`), or from `seed`.
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Mapping
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data import resolve_device
from ..fusion import _writable

GROUPNORM_EPS = 1e-6  # flax's nn.GroupNorm default
# lecun_normal's truncated normal in [-2, 2] has this standard deviation;
# flax divides it out so the kernel's variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@contextlib.contextmanager
def _ieee_f32():
    """float32 convolutions and matrix products in float32 on the card:
    cuDNN runs float32 convolutions in TF32 by default
    (torch.backends.cudnn.allow_tf32), which keeps ~3 decimal digits, and
    a caller may have allowed TF32 products. Both flags are restored on
    exit."""
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    before = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b


class Conv(nn.Module):
    """flax `nn.Conv(features, (k, k), padding="SAME")` with
    param_dtype float32 and dtype bfloat16 (`bf16=True`) or float32.
    weight (out, in, k, k) is the flax kernel (k, k, in, out) permuted."""

    def __init__(self, cin, cout, k, bf16=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.bf16 = bf16

    def forward(self, x):
        if self.bf16:
            y = F.conv2d(x.to(torch.bfloat16),
                         self.weight.to(torch.bfloat16), padding="same")
            # flax rounds the convolution to bf16, then adds the bf16 bias
            return y + self.bias.to(torch.bfloat16)[:, None, None]
        with _ieee_f32():
            y = F.conv2d(x.to(torch.float32), self.weight, padding="same")
        return y + self.bias[:, None, None]


class GroupNorm(nn.GroupNorm):
    """flax `nn.GroupNorm(num_groups=min(32, C))` in float32, eps 1e-6,
    reduced as (N, H * W, groups, C / groups) over the pixels and the
    group's channels. A channels_last input (the models' layout) is
    reduced where it lies: PyTorch's group_norm would copy it to NCHW and
    then give each of the N x groups rows one thread block (32 blocks for
    an image), which made the UNet at 2048x1024 2.4x slower on the H100
    (PERF.md)."""

    def __init__(self, features):
        super().__init__(min(32, features), features, eps=GROUPNORM_EPS)

    def forward(self, x):
        N, C, H, W = x.shape
        G = self.num_groups
        v = x.permute(0, 2, 3, 1).reshape(N, H * W, G, C // G)
        var, mean = torch.var_mean(v, dim=(1, 3), keepdim=True,
                                   correction=0)
        scale = torch.rsqrt(var + self.eps) * self.weight.view(G, C // G)
        y = torch.addcmul(self.bias.view(G, C // G), v - mean, scale)
        return y.reshape(N, H, W, C).permute(0, 3, 1, 2)


class _FlaxNamed(nn.Module):
    """Registers submodules under flax's auto-names only: the class name
    and a per-class counter in creation order, which the subclasses keep
    equal to flax's call order. Their structure is held, unregistered, in
    `self.layers` (a SimpleNamespace), so the state_dict holds each
    parameter once, under its flax path."""

    def _named(self, module):
        counts = self.__dict__.setdefault("_flax_counts", {})
        kind = type(module).__name__
        self.add_module(f"{kind}_{counts.get(kind, 0)}", module)
        counts[kind] = counts.get(kind, 0) + 1
        return module

    def _unet_decoder(self, widths, c, classes):
        """UNet's decoder and head (shared with RGBDUNet): per level a 2x
        nearest upsample, a bf16 1x1 conv, the skip concatenated and a
        ConvBlock; then the float32 1x1 classifier."""
        decoder = []
        for w in reversed(widths[:-1]):
            decoder.append((self._named(Conv(c, w, 1)),
                            self._named(ConvBlock(2 * w, w))))
            c = w
        return decoder, self._named(Conv(c, classes, 1, bf16=False))

    def _unet_decode(self, x, skips):
        for (up, block), skip in zip(self.layers.decoder, reversed(skips)):
            x = up(_upsample2(x)).to(torch.float32)
            x = block(torch.cat([x, skip], dim=1))
        return _to_nhwc(self.layers.head(x))


def norm_gelu(norm, x):
    """A ConvBlock stage's float32 tail: GroupNorm, then flax's `nn.gelu`
    (its tanh form)."""
    return F.gelu(norm(x), approximate="tanh")


class ConvBlock(_FlaxNamed):
    """Two (bf16 3x3 conv -> f32 GroupNorm -> tanh GELU) stages."""

    def __init__(self, cin, features):
        super().__init__()
        self.layers = SimpleNamespace(stages=[
            (self._named(Conv(c, features, 3)),
             self._named(GroupNorm(features)))
            for c in (cin, features)])

    def forward(self, x):
        for conv, norm in self.layers.stages:
            x = norm_gelu(norm, conv(x).to(torch.float32))
        return x


def _to_nchw(x):
    """(B, H, W, C) -> NCHW in channels_last (cuDNN's fast layout)."""
    return x.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def _pool2(x):
    return F.max_pool2d(x, 2, 2)


def _upsample2(x):
    """jax.image.resize(x, 2x, "nearest") of NCHW: output i takes input
    i // 2, as floor((i + 0.5) / 2) is exactly."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class UNet(_FlaxNamed):
    """Encoder-decoder segmentation net: (B, H, W, 3) float32 in [0, 1]
    -> (B, H, W, classes) logits."""

    def __init__(self, classes=19, widths=(64, 128, 256, 512)):
        super().__init__()
        self.classes, self.widths = classes, tuple(widths)
        encoder, cin = [], 3
        for w in self.widths[:-1]:
            encoder.append(self._named(ConvBlock(cin, w)))
            cin = w
        bottleneck = self._named(ConvBlock(cin, self.widths[-1]))
        decoder, head = self._unet_decoder(self.widths, self.widths[-1],
                                           classes)
        self.layers = SimpleNamespace(encoder=encoder, bottleneck=bottleneck,
                                      decoder=decoder, head=head)

    def forward(self, x):
        x = _to_nchw(x)
        skips = []
        for block in self.layers.encoder:
            x = block(x)
            skips.append(x)
            x = _pool2(x)
        return self._unet_decode(self.layers.bottleneck(x), skips)


class PSPNet(_FlaxNamed):
    """Pyramid-scene-parsing net: stride-8 conv encoder, pyramid pooling
    over `bins`, a ConvBlock and the head, then 8x bilinear upsampling."""

    def __init__(self, classes=19, widths=(64, 128, 256, 512),
                 bins=(1, 2, 4, 8)):
        super().__init__()
        self.classes, self.widths, self.bins = (classes, tuple(widths),
                                                tuple(bins))
        encoder, cin = [], 3
        for w in self.widths[:-1]:
            encoder.append(self._named(ConvBlock(cin, w)))
            cin = w
        bottleneck = self._named(ConvBlock(cin, self.widths[-1]))
        c = self.widths[-1]
        cb = c // len(self.bins)
        pyramid = [self._named(Conv(c, cb, 1)) for _ in self.bins]
        fuse = self._named(ConvBlock(c + cb * len(self.bins),
                                     self.widths[-2]))
        head = self._named(Conv(self.widths[-2], classes, 1, bf16=False))
        self.layers = SimpleNamespace(encoder=encoder, bottleneck=bottleneck,
                                      pyramid=pyramid, fuse=fuse, head=head)

    def forward(self, x):
        x = _to_nchw(x)
        for block in self.layers.encoder:
            x = _pool2(block(x))
        x = self.layers.bottleneck(x)
        h, w = x.shape[2:]
        branches = [x]
        for nbins, conv in zip(self.bins, self.layers.pyramid):
            win = (max(h // nbins, 1), max(w // nbins, 1))
            p = conv(F.avg_pool2d(x, win, win)).to(torch.float32)
            branches.append(_bilinear(p, (h, w), (2, 3)))
        logits = self.layers.head(self.layers.fuse(torch.cat(branches, 1)))
        return _to_nhwc(_bilinear(logits, (h * 8, w * 8), (2, 3)))


class RGBDUNet(_FlaxNamed):
    """Dual-encoder RGB-D net: colour and depth encoders, the depth stream
    added into the colour stream at every scale and before the bottleneck,
    UNet's decoder. (B, H, W, 3) + (B, H, W, 1) -> (B, H, W, classes)."""

    def __init__(self, classes=40, widths=(64, 128, 256, 512)):
        super().__init__()
        self.classes, self.widths = classes, tuple(widths)
        encoder, cin = [], (3, 1)
        for w in self.widths[:-1]:
            # flax calls the colour block, then the depth block, per level
            encoder.append((self._named(ConvBlock(cin[0], w)),
                            self._named(ConvBlock(cin[1], w))))
            cin = (w, w)
        bottleneck = self._named(ConvBlock(cin[0], self.widths[-1]))
        decoder, head = self._unet_decoder(self.widths, self.widths[-1],
                                           classes)
        self.layers = SimpleNamespace(encoder=encoder, bottleneck=bottleneck,
                                      decoder=decoder, head=head)

    def forward(self, rgb, depth):
        x, d = _to_nchw(rgb), _to_nchw(depth)
        skips = []
        for rgb_block, depth_block in self.layers.encoder:
            x = rgb_block(x)
            d = depth_block(d)
            x = x + d
            skips.append(x)
            x, d = _pool2(x), _pool2(d)
        return self._unet_decode(self.layers.bottleneck(x + d), skips)


ARCHS = {"unet": UNet, "pspnet": PSPNet, "rgbd": RGBDUNet}


def init_(model, seed=0):
    """flax's initialisation, in place: lecun_normal conv kernels
    (truncated normal in [-2, 2] standard deviations, variance 1 / fan_in),
    zero biases, GroupNorm scale 1 and bias 0, drawn in module order from
    a CPU `torch.Generator` seeded with `seed`. Returns the model."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Conv):
                fan_in = module.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                w = torch.empty(module.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                module.weight.copy_(w)
                module.bias.zero_()
            elif isinstance(module, nn.GroupNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
    return model


# ------------------------------------------------------------------ resizes

def _bilinear_weights(m, n, device):
    """jax.image.resize's (m, n) float32 weights for resizing an axis of m
    samples to n (compute_weight_mat with the triangle kernel): output j
    samples input position (j + 0.5) * m / n - 0.5; the kernel widens by
    m / n where the axis shrinks (antialias); the weights of an output
    are renormalised to sum to 1."""
    inv_scale = 1.0 / (n / m)
    f32 = torch.float32
    # (j + 0.5) * inv_scale - 0.5 rounded once, as XLA contracts it into
    # a fused multiply-add (float64 holds the float32 product exactly);
    # at sample ~600 one float32 rounding more moves a weight by 6e-5
    half = torch.arange(n, dtype=f32, device=device) + 0.5
    inv = torch.tensor(inv_scale, dtype=f32).item()
    sample = (half.double() * inv - 0.5).to(f32)
    x = (sample[None, :] - torch.arange(m, dtype=f32, device=device)[:, None])
    # a true division by a tensor (PyTorch may multiply by the reciprocal
    # of a Python scalar divisor)
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=f32, device=device)
    w = (1.0 - x.abs() / kernel_scale).clamp(min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _bilinear(x, hw, axes):
    """jax.image.resize(..., "bilinear") of float32 `x` over `axes` (two
    axes) to `hw`, as JAX computes it: each axis that changes size is
    contracted with its weight matrix, in float32 (no TF32). An axis that
    keeps its size is left as it is (JAX's weights are the identity)."""
    with _ieee_f32():
        for axis, n in zip(axes, hw):
            m = x.shape[axis]
            if m != n:
                w = _bilinear_weights(m, int(n), x.device)
                x = torch.tensordot(x, w, dims=([axis], [0])).movedim(-1,
                                                                      axis)
    return x.contiguous()


def _nearest_index(m, n, device):
    """jax.image.resize(..., "nearest")'s sample of each of n outputs from
    m inputs: floor((i + 0.5) * m / n), in float32."""
    src = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * m / n
    return torch.floor(src).to(torch.int64)


def _resize_axes(x, hw, lead, method):
    """Resize axes (lead, lead + 1) of x to hw, the other axes kept."""
    hw = tuple(int(v) for v in hw)
    axes = (lead, lead + 1)
    if method == "bilinear":
        return _bilinear(x, hw, axes)
    if method != "nearest":
        raise ValueError(f"unknown resize method {method!r}")
    for axis, n in zip(axes, hw):
        if x.shape[axis] != n:
            x = x.index_select(axis, _nearest_index(x.shape[axis], n,
                                                    x.device))
    return x


def resize(x, hw, method="bilinear"):
    """jax.image.resize of a batch (N, H, W, ...) to (N, hw[0], hw[1],
    ...): "bilinear" (antialiased when it shrinks) or "nearest"."""
    return _resize_axes(x, hw, 1, method)


def _resize_bilinear(img, hw):
    """Bilinear resize of an image's first two axes (H, W, ...)."""
    return _resize_axes(img, hw, 0, "bilinear")


# ----------------------------------------------------------------- inputs

def _tensor(a, device=None):
    """a as a tensor on `device` (None: where it is; numpy on the CPU).
    numpy's unsigned 16/32-bit arrays widen to int64 first."""
    if torch.is_tensor(a):
        return a if device is None else a.to(device)
    a = np.asarray(a)
    if a.dtype in (np.uint16, np.uint32):
        a = a.astype(np.int64)
    t = torch.from_numpy(_writable(a))
    return t if device is None else t.to(device)


def _ensure_rgb(image, device=None):
    """uint8 (H, W) / (H, W, 3) / (H, W, 4) -> (H, W, 3)."""
    image = _tensor(image, device)
    if image.ndim == 2:
        image = torch.stack([image] * 3, dim=-1)
    if image.shape[-1] == 4:
        image = image[..., :3]
    return image


def _ensure_rgb_batch(images, device=None):
    """(N, H, W) / (N, H, W, 1|3|4) -> (N, H, W, 3), so the batch path
    takes every shape the per-image predictor does (sliding() feeds raw
    window crops straight to .batch)."""
    x = _tensor(images, device)
    if x.ndim == 3:
        x = x[..., None]
    if x.shape[-1] == 1:
        x = x.expand(x.shape[:-1] + (3,))
    if x.shape[-1] == 4:
        x = x[..., :3]
    return x


# ------------------------------------------------------------ combinators

def _window_starts(size, win, overlap):
    """Window start offsets covering [0, size) with >= `overlap`
    fractional overlap between neighbours; the last window ends exactly
    at `size` (every pixel covered, no padding)."""
    if size <= win:
        return [0]
    stride = max(int(win * (1.0 - overlap)), 1)  # floor honors >= overlap
    starts = list(range(0, size - win, stride))
    starts.append(size - win)
    return starts


def _carry(wrapper, predict):
    wrapper.params = getattr(predict, "params", None)
    wrapper.model = getattr(predict, "model", None)
    wrapper.base = predict
    return wrapper


def sliding(predict, window_hw, overlap=0.2):
    """Sliding-window inference: wraps `predict(*images) -> (H, W, C)`;
    the inputs are cut into overlapping `window_hw` windows, predicted,
    and the probabilities averaged where windows overlap. Inputs at or
    below the window size pass straight through. Where the predictor has
    `.batch(*stacks)` (the loaders' do), all windows run as one batch;
    windows merge into the sum and the count by static slices."""
    wh, ww = int(window_hw[0]), int(window_hw[1])
    batch = getattr(predict, "batch", None)

    def predict_sliding(*inputs):
        arrs = [_tensor(a) for a in inputs]
        H, W = arrs[0].shape[0], arrs[0].shape[1]
        win_h, win_w = min(wh, H), min(ww, W)
        ys = _window_starts(H, win_h, overlap)
        xs = _window_starts(W, win_w, overlap)
        if len(ys) == 1 and len(xs) == 1:
            return predict(*inputs)
        wins = [tuple(a[y:y + win_h, x:x + win_w] for a in arrs)
                for y in ys for x in xs]
        if batch is not None:
            probs = batch(*(torch.stack([w[i] for w in wins])
                            for i in range(len(arrs))))
        else:
            probs = torch.stack([predict(*w) for w in wins])
        acc = torch.zeros((H, W, probs.shape[-1]), dtype=torch.float32,
                          device=probs.device)
        cnt = torch.zeros((H, W, 1), dtype=torch.float32,
                          device=probs.device)
        k = 0
        for y in ys:
            for x in xs:
                acc[y:y + win_h, x:x + win_w] += probs[k]
                cnt[y:y + win_h, x:x + win_w] += 1.0
                k += 1
        return acc / cnt

    return _carry(predict_sliding, predict)


def multi_scale(predict, scales):
    """Multi-scale inference: `predict` on the inputs resized by each
    scale factor, the probabilities resized back to the native resolution
    and averaged over the scales."""
    scales = [float(s) for s in scales]

    def predict_ms(*inputs):
        arrs = [_tensor(a) for a in inputs]
        H, W = arrs[0].shape[0], arrs[0].shape[1]
        acc = None
        for s in scales:
            hw = (max(int(round(H * s)), 1), max(int(round(W * s)), 1))
            if hw == (H, W):
                p = predict(*arrs)
            else:
                scaled = [_resize_bilinear(a.to(torch.float32), hw)
                          for a in arrs]
                p = _resize_bilinear(predict(*scaled), (H, W))
            acc = p if acc is None else acc + p
        return acc / len(scales)

    return _carry(predict_ms, predict)


# aliases for use inside the loaders, whose kwargs shadow the public names
_sliding_combinator = sliding
_multi_scale_combinator = multi_scale


# ---------------------------------------------------------------- loaders

def _build(arch, classes, widths, params, params_path, seed, device):
    """The model of `arch` on `device` in eval mode, with weights from
    `params` (a port state_dict or a JAX parameter tree), a flax msgpack
    file, or flax's initialisation from `seed`."""
    if params is not None and params_path is not None:
        raise ValueError("pass params or params_path, not both")
    device = resolve_device(device)
    model = ARCHS[arch](classes=classes, widths=tuple(widths))
    if params_path is not None:
        from .serialization import load_flax

        with open(params_path, "rb") as f:
            params = load_flax(f.read())
    if params is None:
        init_(model, seed)
    else:
        if isinstance(params, Mapping) and isinstance(
                params.get("params"), Mapping):
            from ..convert import segmentation_params

            params = segmentation_params(params, arch, widths)
        model.load_state_dict(params)
    model = model.to(device).eval().to(memory_format=torch.channels_last)
    return model, device


def load_predictor(classes=19, params_path=None, input_hw=(512, 512),
                   widths=(64, 128, 256, 512), arch="unet",
                   sliding=None, sliding_overlap=0.2, multi_scale=None,
                   params=None, device="cuda", seed=0):
    """Predictor: uint8 RGB (H, W, 3) -> softmax probs (H, W, classes)
    float32 at the original resolution, on `device`. arch: "unet" |
    "pspnet". The image is resized bilinearly to `input_hw` and the
    probabilities back.

    sliding: optional (h, w) window (overlapping windows, probabilities
    averaged, all windows of an image in one batch); multi_scale:
    optional scale list. Sliding is innermost, as in the reference demo.
    `.batch` ((N, H, W, 3) -> (N, H, W, classes)) exists when neither is
    set; `.params` is the model's state_dict and `.model` the model."""
    model, device = _build(arch, classes, widths, params, params_path, seed,
                           device)
    params = model.state_dict()

    @torch.inference_mode()
    def predict_batch(images):
        """(N, H, W, 3) uint8-like -> (N, H, W, classes), one batch."""
        x = _ensure_rgb_batch(images, device).to(torch.float32) / 255.0
        h, w = x.shape[1:3]
        probs = torch.softmax(model(resize(x, input_hw)), dim=-1)
        return resize(probs, (h, w))

    def predict(image):
        return predict_batch(_ensure_rgb(image)[None])[0]

    predict.params = params
    predict.model = model
    predict.batch = predict_batch
    if sliding is not None:
        predict = _sliding_combinator(predict, sliding, sliding_overlap)
    if multi_scale:
        predict = _multi_scale_combinator(predict, multi_scale)

    def predict_rgb(image, _p=predict):
        return _p(_ensure_rgb(image, device))

    predict_rgb.params = params
    predict_rgb.model = model
    if sliding is None and not multi_scale:
        predict_rgb.batch = predict_batch
    return predict_rgb


def load_rgbd_predictor(classes=40, params_path=None, input_hw=(480, 640),
                        widths=(64, 128, 256, 512), depth_scale=1e-3,
                        sliding=None, sliding_overlap=0.2, multi_scale=None,
                        params=None, device="cuda", seed=0):
    """RGB-D predictor: (color uint8 (H, W, 3), depth uint16/float (H, W))
    -> softmax probs (H, W, classes) at the color resolution, on `device`.
    Depth times `depth_scale` (metres) is resized to the colour resolution
    first, so window and scale crops of the two streams stay aligned.
    sliding / multi_scale: see load_predictor."""
    model, device = _build("rgbd", classes, widths, params, params_path,
                           seed, device)
    params = model.state_dict()

    @torch.inference_mode()
    def predict_batch(colors, depths):
        """(N, H, W, 3) + (N, H, W, 1) [metres] -> (N, H, W, classes)."""
        rgb = _ensure_rgb_batch(colors, device).to(torch.float32) / 255.0
        h, w = rgb.shape[1:3]
        d = resize(_tensor(depths, device).to(torch.float32), input_hw)
        probs = torch.softmax(model(resize(rgb, input_hw), d), dim=-1)
        return resize(probs, (h, w))

    def predict_core(color, depth_m):
        return predict_batch(color[None], depth_m[None])[0]

    predict_core.params = params
    predict_core.model = model
    predict_core.batch = predict_batch
    core = predict_core
    if sliding is not None:
        core = _sliding_combinator(core, sliding, sliding_overlap)
    if multi_scale:
        core = _multi_scale_combinator(core, multi_scale)

    def predict(color, depth):
        color = _ensure_rgb(color, device)
        d = _tensor(depth, device).to(torch.float32) * depth_scale
        return core(color, _resize_bilinear(d[..., None], color.shape[:2]))

    predict.params = params
    predict.model = model
    return predict
