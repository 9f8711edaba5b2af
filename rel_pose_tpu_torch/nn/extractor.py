"""Residual conv block from the ResNet trunk to the transformer tokens.

Counterpart of ``rel_pose_tpu/nn/extractor.py:40-55`` (the reference's
``ResidualBlock(128, 192, 'batch', kernel_size=5)``), BN folded in eval
mode and on batch statistics in training mode (``nn.layers.conv_bn``):

  y = relu(BN(conv3x3 pad1 (in->out)))
  y = relu(BN(conv kxk no-pad (out->out)))
  x = BN(conv kxk no-pad (in->out))            # the "downsample" branch
  out = relu(x + y)

(N, 128, 28, 28) -> (N, 192, 24, 24).  The reference registers norm3 a
second time as ``downsample.1``; here ``downsample`` holds only the conv, so
the module's keys are exactly those of ``rel_pose_tpu.utils.convert``'s key
map and the duplicate is dropped on load.
"""

import torch
from torch import nn

from .layers import conv_bn


class ResidualBlock(nn.Module):
    def __init__(self, in_ch, out_ch, kernel_size):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, 1, 1)
        self.norm1 = nn.BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, kernel_size, 1, 0)
        self.norm2 = nn.BatchNorm2d(out_ch)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, kernel_size, 1, 0))
        self.norm3 = nn.BatchNorm2d(out_ch)

    def forward(self, x):
        t = self.training
        y = torch.relu(conv_bn(x, self.conv1, self.norm1, t))
        y = torch.relu(conv_bn(y, self.conv2, self.norm2, t))
        x = conv_bn(x, self.downsample[0], self.norm3, t)
        return torch.relu(x + y)
