"""LPIPS perceptual distance with a VGG16 backbone.

Port of pixart_sigma_tpu/models/lpips.py (the `lpips` package's
LPIPS(net='vgg'), which DMD's regression loss uses): the scaling layer,
VGG16's convolutions with taps after each stage's last ReLU (relu1_2,
relu2_2, relu3_3, relu4_3, relu5_3), each tap unit-normalised over its
channels, squared differences weighed by a 1x1 head per tap, the spatial
mean, summed over the taps. NHWC images in [-1, 1] at the public boundary.

Module names are torchvision's (`vgg.features.<i>`) and the `lpips`
package's (`lin<i>.model.1`), so their `vgg16` and `vgg.pth` weights load
through `lpips_state_dict`; `torch_lpips_to_flax` and `flax_lpips_to_torch`
carry the JAX package's params across. Without weights, `build_lpips`
draws a seeded random VGG (normal kernels of variance 1 / fan_in, flax's
lecun scale without its truncation) with heads of ones, as the JAX
package's init.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch
from torch import nn

from pixart_sigma_tpu_torch.utils.device import resolve_device

# VGG16 conv plan: (channels, convs per stage); a tap after each stage's ReLU
VGG_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def _vgg_layers() -> Tuple[List[nn.Module], List[int]]:
    """torchvision's vgg16().features (31 layers) and the indices of the
    ReLUs LPIPS taps."""
    layers, taps, cin = [], [], 3
    for stage, (ch, n) in enumerate(VGG_PLAN):
        for _ in range(n):
            layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
            cin = ch
        taps.append(len(layers) - 1)
        layers.append(nn.MaxPool2d(2, 2))
    return layers, taps


class VGG16Features(nn.Module):
    """[B, H, W, 3] in [-1, 1] -> the 5 tap activations, NCHW."""

    def __init__(self):
        super().__init__()
        layers, self.taps = _vgg_layers()
        self.features = nn.Sequential(*layers)
        self.register_buffer("shift", torch.tensor(SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).reshape(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        dtype = self.features[0].weight.dtype
        x = ((x.permute(0, 3, 1, 2).float() - self.shift) / self.scale).to(dtype)
        out = []
        for i, layer in enumerate(self.features[: self.taps[-1] + 1]):
            x = layer(x)
            if i in self.taps:
                out.append(x)
        return out


class _Head(nn.Module):
    """The `lpips` package's NetLinLayer: a 1x1 conv to one channel, no bias
    (its dropout is off in eval)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


class LPIPS(nn.Module):
    """lpips(img0, img1) -> [B] perceptual distances; inputs NHWC in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(VGG_PLAN):
            setattr(self, f"lin{i}", _Head(ch))

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        f0, f1 = self.vgg(x0), self.vgg(x1)
        total = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            a = a / a.norm(dim=1, keepdim=True).clamp_min(1e-10)
            b = b / b.norm(dim=1, keepdim=True).clamp_min(1e-10)
            total = total + getattr(self, f"lin{i}")((a - b) ** 2)[:, 0].mean(dim=(1, 2))
        return total


# ------------------------------------------------------------------ weights
def lpips_state_dict(vgg_sd: Dict[str, Any], lin_sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """torchvision VGG16 `features.*` and the lpips package's
    `lin<i>.model.1.weight` -> the port's LPIPS state dict."""
    sd = {f"vgg.{k}": torch.as_tensor(np.asarray(v)) for k, v in vgg_sd.items()
          if k.startswith("features.")}
    sd.update({k: torch.as_tensor(np.asarray(lin_sd[k])) for k in
               (f"lin{i}.model.1.weight" for i in range(len(VGG_PLAN)))})
    return sd


def torch_lpips_to_flax(vgg_sd: Dict[str, Any], lin_sd: Dict[str, Any]) -> Dict[str, Any]:
    """torchvision VGG16 `features.*` + lpips `lin<i>.model.1.weight` -> the
    JAX package's LPIPS params (numpy; conv kernels HWIO)."""
    params: Dict[str, Any] = {"vgg": {}}
    conv_layers = [j for j in range(31) if f"features.{j}.weight" in vgg_sd]
    for idx, layer in enumerate(conv_layers):
        w = np.asarray(vgg_sd[f"features.{layer}.weight"])  # [O, I, 3, 3]
        params["vgg"][f"conv_{idx}"] = {"kernel": w.transpose(2, 3, 1, 0),
                                        "bias": np.asarray(vgg_sd[f"features.{layer}.bias"])}
    for i in range(len(VGG_PLAN)):
        w = np.asarray(lin_sd[f"lin{i}.model.1.weight"])  # [1, C, 1, 1]
        params[f"lin_{i}"] = {"kernel": w[:, :, 0, 0].T}
    return params


def flax_lpips_to_torch(params: Dict[str, Any]) -> Tuple[Dict[str, torch.Tensor],
                                                         Dict[str, torch.Tensor]]:
    """The JAX package's LPIPS params -> (torchvision VGG16 `features.*`,
    lpips `lin<i>.model.1.weight`); the inverse of `torch_lpips_to_flax`."""
    layers, _ = _vgg_layers()
    convs = [j for j, layer in enumerate(layers) if isinstance(layer, nn.Conv2d)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))
    vgg_sd, lin_sd = {}, {}
    for idx, j in enumerate(convs):
        conv = params["vgg"][f"conv_{idx}"]
        vgg_sd[f"features.{j}.weight"] = t(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
        vgg_sd[f"features.{j}.bias"] = t(conv["bias"])
    for i in range(len(VGG_PLAN)):
        lin_sd[f"lin{i}.model.1.weight"] = t(np.asarray(params[f"lin_{i}"]["kernel"]).T[
            :, :, None, None])
    return vgg_sd, lin_sd


def build_lpips(device: Union[str, torch.device] = "cuda", seed: int = 0,
                dtype: torch.dtype = torch.float32) -> LPIPS:
    """LPIPS with a seeded random VGG: normal kernels of std 1/sqrt(fan_in)
    from a CPU generator in layer order, biases 0, heads of ones; frozen, in
    eval. Load weights with `lpips_state_dict`."""
    model = LPIPS()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("vgg.") and name.endswith(".weight"):
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(fan_in))
            elif name.startswith("vgg."):
                p.zero_()
            else:
                p.fill_(1.0)
    return model.to(resolve_device(device), dtype).eval().requires_grad_(False)
