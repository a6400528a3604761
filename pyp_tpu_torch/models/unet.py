"""Compact 2D U-Net — the shared backbone of the learned picker (heatmap
regression), the noise2noise and wedge denoisers and the membrane
segmenter — and the flax-convention layers every model of the port is
built from. The torch port of pyp_tpu/models/unet.py.

The layers compute what flax.linen's do, in NCHW / NCDHW layout:

- `Conv`: "SAME" padding as XLA computes it for any stride — a total of
  max((ceil(n/s) - 1)·s + k - n, 0) with the smaller half in front, so a
  stride-2 convolution of an even size pads (0, 1), not (1, 1);
- `ConvTranspose`: flax's transposed convolution ("SAME", no kernel
  flip in flax's layout): `conv_transpose` of the flipped kernel, cut to
  n·s outputs from where XLA's padding puts the first one;
- `GroupNorm`: epsilon 1e-6 (torch's default is 1e-5);
- `Dense`: a linear layer.

Constructors leave kernels and biases at zero and GroupNorm scales at
one; `init_params` draws the kernels as flax does (every trainer calls
it). Parameters are kept in torch's layout (`kernel` (out, in, *k), for
`ConvTranspose` (in, out, *k) flipped); `models.io` converts to flax's.
Submodules carry flax's automatic names (`ConvBlock_0`, `Conv_0`, ...),
which is how `models.io` maps a state dict onto flax's parameter tree.

Precision: convolutions run at the process's cuDNN setting (PyTorch's
default on Hopper: TF32), dense layers at its matmul setting (default
FP32); the port flips no process-wide flag.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pyp_tpu_torch import rows_per_call


def _tuple(v, nd):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),) * nd


class Conv(nn.Module):
    """flax.linen.Conv with "SAME" padding and a bias."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=1):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = _tuple(strides, len(self.kernel_size))
        self.kernel = nn.Parameter(
            torch.zeros((features, in_features) + self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def fan_in(self) -> int:
        return self.kernel.shape[1] * math.prod(self.kernel_size)

    def forward(self, x):
        pads = []
        spatial = x.shape[2:]
        for n, k, s in reversed(list(zip(spatial, self.kernel_size,
                                         self.strides))):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(x, pads)
        conv = F.conv2d if len(self.kernel_size) == 2 else F.conv3d
        return conv(x, self.kernel, self.bias, stride=self.strides)


def _transpose_padding(k: int, s: int):
    """XLA's "SAME" padding of a transposed convolution (the input
    dilated by s, then correlated with the kernel): (front, back)."""
    pad_len = k + s - 2
    front = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return front, pad_len - front


class ConvTranspose(nn.Module):
    """flax.linen.ConvTranspose with "SAME" padding and a bias: n·s
    outputs per spatial axis."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=1):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = _tuple(strides, len(self.kernel_size))
        self.kernel = nn.Parameter(
            torch.zeros((in_features, features) + self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def fan_in(self) -> int:
        return self.kernel.shape[0] * math.prod(self.kernel_size)

    def forward(self, x):
        nd = len(self.kernel_size)
        conv_t = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
        # torch's full transposed convolution is the dilated input padded
        # by k - 1 and correlated with the flipped kernel; XLA's pads by
        # `front` instead, so its first output sits k - 1 - front later
        y = conv_t(x, self.kernel, stride=self.strides)
        for axis, (n, k, s) in enumerate(zip(x.shape[2:], self.kernel_size,
                                             self.strides)):
            front, _ = _transpose_padding(k, s)
            lo, want = k - 1 - front, n * s
            dim = 2 + axis
            have = y.shape[dim] - lo
            if have < want:
                pad = [0, 0] * (y.ndim - dim - 1) + [0, want - have]
                y = F.pad(y, pad)
            y = y.narrow(dim, lo, want)
        return y + self.bias.reshape((1, -1) + (1,) * nd)


class GroupNorm(nn.Module):
    """flax.linen.GroupNorm: epsilon 1e-6, a scale and a bias."""

    def __init__(self, num_groups: int, features: int):
        super().__init__()
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.scale, self.bias,
                            eps=1e-6)


class Dense(nn.Module):
    """flax.linen.Dense: kernel (out, in) here ((in, out) in flax)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def fan_in(self) -> int:
        return self.kernel.shape[1]

    def forward(self, x):
        return F.linear(x, self.kernel, self.bias)


def _truncated_normal(shape, std, generator):
    """Normal draws truncated to [-2, 2], times `std`, by the inverse CDF
    (flax's `truncated_normal` initialiser)."""
    lo, hi = (0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    u = lo + (hi - lo) * u
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return (x * std).to(torch.float32)


def init_params(module: nn.Module, seed: int = 0) -> nn.Module:
    """Initialise `module` in place as flax does, from a CPU generator
    seeded with `seed` (the same weights on every device): lecun-normal
    kernels (a normal truncated at 2 sigma, fan-in variance), zero
    biases, GroupNorm scale 1 and bias 0. Every trainer starts here."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for _, layer in module.named_modules():
            if isinstance(layer, (Conv, ConvTranspose, Dense)):
                # flax's variance_scaling(1, "fan_in", "truncated_normal")
                std = math.sqrt(1.0 / layer.fan_in()) / 0.87962566103423978
                layer.kernel.copy_(_truncated_normal(
                    layer.kernel.shape, std, gen))
                layer.bias.zero_()
            elif isinstance(layer, GroupNorm):
                layer.scale.fill_(1.0)
                layer.bias.zero_()
    return module


class ConvBlock(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        g = min(8, features)
        self.Conv_0 = Conv(in_features, features, (3, 3))
        self.GroupNorm_0 = GroupNorm(g, features)
        self.Conv_1 = Conv(features, features, (3, 3))
        self.GroupNorm_1 = GroupNorm(g, features)

    def forward(self, x):
        x = F.silu(self.GroupNorm_0(self.Conv_0(x)))
        return F.silu(self.GroupNorm_1(self.Conv_1(x)))


class UNet2D(nn.Module):
    """Encoder-decoder with skip connections; `out_channels` heads.
    x: (B, in_channels, H, W) with H and W multiples of
    2^(len(features) - 1)."""

    def __init__(self, features: Sequence[int] = (16, 32, 64),
                 out_channels: int = 1, in_channels: int = 1):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        blocks, ups = [], []
        c = in_channels
        for f in self.features[:-1]:
            blocks.append(ConvBlock(c, f))
            c = f
        blocks.append(ConvBlock(c, self.features[-1]))
        c = self.features[-1]
        for f in reversed(self.features[:-1]):
            ups.append(ConvTranspose(c, f, (2, 2), strides=2))
            blocks.append(ConvBlock(2 * f, f))
            c = f
        # flax's names: ConvBlock_i by call order, ConvTranspose_j
        for i, b in enumerate(blocks):
            self.add_module(f"ConvBlock_{i}", b)
        for j, u in enumerate(ups):
            self.add_module(f"ConvTranspose_{j}", u)
        self.Conv_0 = Conv(c, out_channels, (1, 1))

    def forward(self, x):
        n_down = len(self.features) - 1
        skips = []
        for i in range(n_down):
            x = getattr(self, f"ConvBlock_{i}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = getattr(self, f"ConvBlock_{n_down}")(x)
        for j, skip in enumerate(reversed(skips)):
            x = getattr(self, f"ConvTranspose_{j}")(x)
            x = torch.cat([x, skip], dim=1)
            x = getattr(self, f"ConvBlock_{n_down + 1 + j}")(x)
        return self.Conv_0(x)


def cpu_state(module: nn.Module) -> dict:
    """A trained module's state dict, detached and on the CPU (the
    models' NamedTuples carry their weights so)."""
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def loaded_unet(params, features, device) -> UNet2D:
    """A single-head UNet2D of `features` widths with `params`, on
    `device`, for inference."""
    net = UNet2D(features=features, out_channels=1)
    net.load_state_dict(params)
    return net.to(device).eval()


def tile_batch(device, total: int, tile_elems: int, features) -> int:
    """Tiles (or slices) of `tile_elems` pixels to push through a network
    of `features` widths at once: all of them on the CPU, else as many as
    a quarter of the card's free memory holds at a generous estimate of
    the forward's live activations (no gradient kept). GroupNorm
    normalises each sample on its own, so the split changes no result."""
    per = 4 * tile_elems * (8 + 6 * sum(int(f) for f in features))
    return rows_per_call(device, total, per)


def apply_tiled(net: nn.Module, imgs, patch: int, features, post=None):
    """The JAX package's tiled inference, batched: `net` over every
    patch² tile of each (H, W) image of `imgs` (N, H, W) on the JAX
    loops' grid (stride patch // 2, tile origins while a whole tile fits;
    one tile of the image's own size along an axis shorter than `patch`),
    `post` applied to each tile's output, and the overlaps averaged.
    Tiles are cut with `unfold` and blended with `fold` on the device,
    as many at once as `tile_batch` allows. Returns (N, H, W)."""
    n, ny, nx = imgs.shape
    ty, tx = min(patch, ny), min(patch, nx)
    stride = max(patch // 2, 1)
    cols = F.unfold(imgs[:, None], (ty, tx), stride=stride)   # (N, ty tx, L)
    n_tiles = cols.shape[-1]
    tiles = cols.transpose(1, 2).reshape(n * n_tiles, 1, ty, tx)
    out = torch.empty_like(tiles)
    step = tile_batch(imgs.device, len(tiles), ty * tx, features)
    with torch.no_grad():
        for lo in range(0, len(tiles), step):
            y = net(tiles[lo:lo + step])
            out[lo:lo + step] = post(y) if post is not None else y
    cols = out.reshape(n, n_tiles, ty * tx).transpose(1, 2)
    total = F.fold(cols, (ny, nx), (ty, tx), stride=stride)
    weight = F.fold(torch.ones_like(cols[:1]), (ny, nx), (ty, tx),
                    stride=stride)
    return (total / torch.clamp(weight, min=1.0))[:, 0]
