"""VGN 3D-CNN grasp head (graspnerf_tpu/models/grasp_head.py:65-90) with the
native Conv3d (padding k//2, stride-2 encoder) and nearest upsampling to
res/4, res/2, res. Channels-last at the boundary like the JAX module:
vol [B,X,Y,Z,1] -> qual [B,X,Y,Z,1], rot [B,X,Y,Z,4] (unit xyzw), width
[B,X,Y,Z,1]. Inside, NCDHW with D = X. Every Conv3d computes in `dtype`
(grasp_head.py:19-58); the three outputs come back in float32
(grasp_head.py:83-89)."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interpolate import resize_nearest_3d
from .layers import Conv3d


def _conv3d(cin, cout, k, stride=1, dtype=torch.float32):
    return Conv3d(cin, cout, k, stride, padding=k // 2, dtype=dtype)


class _Encoder(nn.Module):
    def __init__(self, dtype):
        super().__init__()
        self.conv1 = _conv3d(1, 16, 5, 2, dtype)
        self.conv2 = _conv3d(16, 32, 3, 2, dtype)
        self.conv3 = _conv3d(32, 64, 3, 2, dtype)


class _Decoder(nn.Module):
    def __init__(self, dtype):
        super().__init__()
        self.conv1 = _conv3d(64, 64, 3, dtype=dtype)
        self.conv2 = _conv3d(64, 32, 3, dtype=dtype)
        self.conv3 = _conv3d(32, 16, 5, dtype=dtype)


class VGNConvNet(nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.encoder = _Encoder(dtype)
        self.decoder = _Decoder(dtype)
        self.conv_qual = _conv3d(16, 1, 5, dtype=dtype)
        self.conv_rot = _conv3d(16, 4, 5, dtype=dtype)
        self.conv_width = _conv3d(16, 1, 5, dtype=dtype)

    def forward(self, vol):
        res = vol.shape[1]
        x = vol.permute(0, 4, 1, 2, 3)
        e, d = self.encoder, self.decoder
        x = F.relu(e.conv3(F.relu(e.conv2(F.relu(e.conv1(x))))))
        x = F.relu(d.conv1(x))
        x = resize_nearest_3d(x, res // 4, res // 4, res // 4)
        x = F.relu(d.conv2(x))
        x = resize_nearest_3d(x, res // 2, res // 2, res // 2)
        x = F.relu(d.conv3(x))
        x = resize_nearest_3d(x, res, res, res)
        qual = torch.sigmoid(self.conv_qual(x).float())
        rot = self.conv_rot(x).float()
        rot = rot / torch.linalg.norm(rot, dim=1, keepdim=True).clamp_min(1e-12)
        width = self.conv_width(x).float()
        return tuple(t.permute(0, 2, 3, 4, 1) for t in (qual, rot, width))
