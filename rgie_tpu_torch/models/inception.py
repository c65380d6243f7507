"""Inception-v3, the calibrated feature extractor for FID, KID and ISC. Port
of ``rgie_tpu/models/inception.py``.

Reference: ``src/analysis/process_result_images.py:78-87`` calls
torch_fidelity's ``calculate_metrics(isc=True, fid=True, kid=True)``, whose
feature extractor is the TF-ported Inception-v3 of pytorch-fid: torchvision's
``inception_v3`` graph with three pooling quirks (the "FID variant"):

  * the InceptionA/C/E pool branches average with ``count_include_pad=False``,
  * the last InceptionE block (Mixed_7c) pools its branch with a 3x3/1 max,
  * ``fc`` has 1008 outputs (the TF class layout), used for the Inception Score.

``fid_variant=False`` gives the stock torchvision graph. Module names are
torchvision's (pytorch-fid's ``pt_inception-2015-12-05`` uses the same), so
either checkpoint loads with ``load_state_dict(strict=True)``; the auxiliary
head is not built (eval only), and its keys are dropped on load.

Input: (B, 299, 299, 3) NHWC in [-1, 1] (``preprocess`` makes it from [0, 1]
images of any size: bilinear resize to 299, then 2x - 1). Returns (pool
features (B, 2048), logits (B, num_classes)), both float32.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from rgie_tpu_torch.ops import geometry as G


def _avg_pool_3x3_s1(x: torch.Tensor, fid_variant: bool) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=not fid_variant)


class BasicConv2d(nn.Module):
    """torchvision BasicConv2d: conv (no bias) + BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, bias=False, **kw)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, fid_variant: bool = True):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(cin, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_s1(x, self.fid_variant))
        return torch.cat([self.branch1x1(x), b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int, fid_variant: bool = True):
        super().__init__()
        c7 = channels_7x7
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3_s1(x, self.fid_variant))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool_mode``: "avg" (Mixed_7b; ``count_include_pad=False`` in the FID
    variant) or "max" (Mixed_7c in the FID variant only)."""

    def __init__(self, cin: int, pool_mode: str = "avg", fid_variant: bool = True):
        super().__init__()
        self.pool_mode = pool_mode
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(cin, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(cin, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_mode == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool_3x3_s1(x, self.fid_variant)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


MIXED = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
         "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c")


class InceptionV3(nn.Module):
    """torchvision's ``inception_v3`` graph without the auxiliary head (eval
    only). ``num_classes=1008`` is the TF-ported FID checkpoint's;
    torchvision's ImageNet weights have 1000."""

    def __init__(self, num_classes: int = 1008, fid_variant: bool = True):
        super().__init__()
        fv = fid_variant
        self.num_classes, self.fid_variant = num_classes, fid_variant
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32, fv)
        self.Mixed_5c = InceptionA(256, 64, fv)
        self.Mixed_5d = InceptionA(288, 64, fv)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fv)
        self.Mixed_6c = InceptionC(768, 160, fv)
        self.Mixed_6d = InceptionC(768, 160, fv)
        self.Mixed_6e = InceptionC(768, 192, fv)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg", fv)
        self.Mixed_7c = InceptionE(2048, "max" if fv else "avg", fv)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) NHWC in [-1, 1] -> (features (B, 2048), logits)."""
        x = x.float().permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in MIXED:
            x = getattr(self, name)(x)
        feats = x.mean(dim=(2, 3))                 # adaptive average pool to 1 x 1
        return feats, self.fc(feats)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # torchvision's checkpoints carry the auxiliary head this graph omits.
        for key in [k for k in state_dict if k.startswith(prefix + "AuxLogits.")]:
            del state_dict[key]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] images (B, H, W, 3) -> [-1, 1] at 299 px (pytorch-fid's
    conventions: a bilinear resize without corner alignment, then 2x - 1; as
    ``jax.image.resize``, a downsizing resize is antialiased)."""
    if images.shape[1:3] != (299, 299):
        images = G.resize(images, (299, 299), antialias=True)
    return images * 2.0 - 1.0


def create_inception(generator: torch.Generator, num_classes: int = 1008,
                     fid_variant: bool = True) -> InceptionV3:
    """A frozen random-weight Inception-v3 on the CPU, drawn from
    ``generator`` (stand-in for the pytorch-fid checkpoint)."""
    from rgie_tpu_torch.models.init import freeze_, random_init_

    return freeze_(random_init_(InceptionV3(num_classes, fid_variant), generator))


def load_inception(state_dict: Mapping[str, torch.Tensor], fid_variant: bool = True
                   ) -> InceptionV3:
    """A frozen Inception-v3 on the CPU from a torchvision or pytorch-fid
    state dict; the class count is read from ``fc.weight``."""
    from rgie_tpu_torch.models.init import freeze_

    model = InceptionV3(int(state_dict["fc.weight"].shape[0]), fid_variant)
    model.load_state_dict(dict(state_dict), strict=True)
    return freeze_(model)


def make_feature_extractor(model: InceptionV3, batch_size: int = 32,
                           device: Optional[torch.device] = None
                           ) -> Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """images (N, H, W, 3) in [0, 1], numpy -> ((N, 2048) features, (N, C)
    softmax probabilities), numpy float32, in batches of ``batch_size`` on
    the model's device. The pair ``analysis.fid.calculate_metrics`` takes
    from one extractor call."""
    device = device or next(model.parameters()).device

    @torch.no_grad()
    def extract(images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        fs, ps = [], []
        for i in range(0, len(images), batch_size):
            batch = torch.as_tensor(np.asarray(images[i:i + batch_size], np.float32),
                                    device=device)
            feats, logits = model(preprocess(batch))
            fs.append(feats.cpu().numpy())
            ps.append(torch.softmax(logits, dim=-1).cpu().numpy())
        return np.concatenate(fs, axis=0), np.concatenate(ps, axis=0)

    return extract

