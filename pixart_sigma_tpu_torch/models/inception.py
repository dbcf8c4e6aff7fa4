"""InceptionV3 feature extractor of FID (pytorch-fid's network).

Port of pixart_sigma_tpu/models/inception.py: the TF-Inception port that
every published FID uses, with its three departures from torchvision kept:

- the A and C blocks and Mixed_7b pool with a 3x3 stride-1 average that
  excludes the zero padding from the divisor (count_include_pad=False);
- Mixed_7c pools with a 3x3 stride-1 max instead;
- inputs are resized to 299x299 (bilinear, half-pixel centres) and mapped
  from [0, 1] to [-1, 1].

The resize is `jax.image.resize(..., "bilinear")`'s: a triangle filter
widened by the scale when it shrinks an image (antialiased), which is
`F.interpolate(mode="bilinear", antialias=True)`; without the antialias a
1024px image would be sampled, not filtered, down to 299.

Module names are pytorch-fid's (`Mixed_5b.branch1x1.conv.weight`), so its
`pt_inception-2015-12-05` state dict loads as is (`load_fid_inception`);
`torch_inception_to_flax` and `flax_inception_to_torch` carry the JAX
package's variables across. BatchNorm is eval-mode only: an affine from the
stored statistics (eps 1e-3). NHWC at the public boundary, NCHW inside.
Without weights, `random_inception_params` gives a fixed-seed He-normal
extractor: FID against it is a relative statistic, not comparable to
published numbers.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pixart_sigma_tpu_torch.utils.device import resolve_device

FEATURE_DIM = 2048
INPUT_SIZE = 299


def avg_pool_3x3_exclude_pad(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 same-size average, the padding left out of the divisor."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 299, 299]: `jax.image.resize` bilinear (a
    triangle filter, widened by the scale when shrinking)."""
    return F.interpolate(x, size=(INPUT_SIZE, INPUT_SIZE), mode="bilinear",
                         align_corners=False, antialias=True)


class _EvalBatchNorm(nn.Module):
    """BatchNorm at inference: (x - mean) / sqrt(var + eps) * weight + bias."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


class BasicConv2d(nn.Module):
    """Conv (no bias) + eval-mode BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = _EvalBatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_3x3_exclude_pad(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(avg_pool_3x3_exclude_pad(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """pool_mode "avg": Mixed_7b (FIDInceptionE_1); "max": Mixed_7c."""

    def __init__(self, cin: int, pool_mode: str):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_mode == "avg":
            bp = avg_pool_3x3_exclude_pad(x)
        else:  # Mixed_7c: the TF port's max pool, kept for FID parity
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """FID feature extractor: [B, H, W, 3] in [0, 1] -> [B, 2048] f32, as
    pytorch-fid's InceptionV3([3], resize_input=True, normalize_input=True)
    final pool."""

    def __init__(self, resize_input: bool = True, normalize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.Conv2d_1a_3x3.conv.weight.dtype
        x = x.float().permute(0, 3, 1, 2)
        if self.resize_input and tuple(x.shape[2:]) != (INPUT_SIZE, INPUT_SIZE):
            x = resize_299(x)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = x.to(dtype)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x.mean(dim=(2, 3)).float()  # adaptive_avg_pool2d(1)


# ------------------------------------------------------------------ weights
def inception_state_dict(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A pt_inception / torchvision inception_v3 state dict without the
    heads FID does not use (fc, AuxLogits) and BatchNorm's step counters."""
    return {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()
            if k.split(".")[0] not in ("fc", "AuxLogits")
            and not k.endswith("num_batches_tracked")}


def torch_inception_to_flax(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """pt_inception state dict -> the JAX package's {'params', 'batch_stats'}
    (numpy arrays; conv kernels HWIO); the fc / AuxLogits heads are dropped."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, path: Sequence[str], leaf_key: str, v):
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf_key] = v

    for key, val in inception_state_dict(state_dict).items():
        v = val.numpy()
        *mods, kind, leaf = key.split(".")
        if kind == "conv" and leaf == "weight":
            put(params, mods + ["conv"], "kernel", v.transpose(2, 3, 1, 0))
        elif kind == "bn" and leaf == "weight":
            put(params, mods + ["bn"], "scale", v)
        elif kind == "bn" and leaf == "bias":
            put(params, mods + ["bn"], "bias", v)
        elif kind == "bn" and leaf == "running_mean":
            put(stats, mods + ["bn"], "mean", v)
        elif kind == "bn" and leaf == "running_var":
            put(stats, mods + ["bn"], "var", v)
        else:
            raise ValueError(f"unrecognised inception key: {key}")
    return {"params": params, "batch_stats": stats}


def flax_inception_to_torch(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's {'params', 'batch_stats'} -> the port's (and
    pt_inception's) state dict; the inverse of `torch_inception_to_flax`."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, path + [k])
        else:
            yield path, np.asarray(tree, dtype=np.float32)

    names = {("conv", "kernel"): "conv.weight", ("bn", "scale"): "bn.weight",
             ("bn", "bias"): "bn.bias", ("bn", "mean"): "bn.running_mean",
             ("bn", "var"): "bn.running_var"}
    for group in ("params", "batch_stats"):
        for path, v in walk(variables[group], []):
            *mods, kind, leaf = path
            if (kind, leaf) not in names:
                raise ValueError(f"unrecognised inception variable: {'/'.join(path)}")
            if leaf == "kernel":
                v = v.transpose(3, 2, 0, 1)
            sd[".".join(mods + [names[(kind, leaf)]])] = torch.from_numpy(np.ascontiguousarray(v))
    return sd


def build_inception(device: Union[str, torch.device] = "cuda",
                    dtype: torch.dtype = torch.float32, **kw) -> InceptionV3:
    dev = resolve_device(device)
    return InceptionV3(**kw).to(dev, dtype).eval().requires_grad_(False)


def load_fid_inception(path: str, device: Union[str, torch.device] = "cuda",
                       dtype: torch.dtype = torch.float32) -> InceptionV3:
    """pytorch-fid's `pt_inception-2015-12-05` `.pth` -> the extractor."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model = build_inception(device, dtype)
    model.load_state_dict(inception_state_dict(sd), strict=True)
    return model


def random_inception_params(seed: int = 0, device: Union[str, torch.device] = "cuda",
                            dtype: torch.dtype = torch.float32) -> InceptionV3:
    """The fixed-seed random extractor: every conv kernel He-normal (std
    sqrt(2 / fan_in)) from a CPU generator seeded `seed`, drawn in module
    order; BatchNorm at its defaults. (A lecun init halves the variance at
    every ReLU and over ~47 convs the inter-image signal collapses; He keeps
    the embedding a discriminative random projection.) The draws differ
    from JAX's key splits: carry JAX's variables with
    `flax_inception_to_torch` to compare."""
    model = build_inception("cpu", torch.float32)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("conv.weight"):
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=gen) * np.sqrt(2.0 / fan_in))
    return model.to(resolve_device(device), dtype)


def extract_activations(model: InceptionV3, images: np.ndarray, batch: int = 32) -> np.ndarray:
    """images [N, H, W, 3] in [0, 1] -> activations [N, 2048] f32, `batch`
    images per call on the model's device (the last call takes the rest)."""
    dev = model.Conv2d_1a_3x3.conv.weight.device
    out = np.empty((images.shape[0], FEATURE_DIM), np.float32)
    with torch.no_grad():
        for i in range(0, images.shape[0], batch):
            chunk = torch.from_numpy(np.ascontiguousarray(images[i:i + batch], np.float32))
            out[i:i + chunk.shape[0]] = model(chunk.to(dev)).cpu().numpy()
    return out
