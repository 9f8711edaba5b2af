"""ResNet-18 trunk through layer2.

Counterpart of ``rel_pose_tpu/nn/resnet.py:97-154`` with the plain 7x7/s2
stem (the JAX eval path's space-to-depth stem is a TPU rewrite of the same
arithmetic).  Attribute names reproduce torchvision's, so the reference
state-dict keys ``resnet.conv1``, ``resnet.layer2.0.downsample.0`` ... load
as they are.

  stem:   conv 7x7/2 pad3 (3->64) -> BN -> ReLU -> maxpool 3x3/2 pad1
  layer1: 2x BasicBlock(64->64, stride 1)
  layer2: BasicBlock(64->128, stride 2, 1x1 downsample) + BasicBlock(128)

(N, 3, 224, 224) -> (N, 128, 28, 28).  In eval mode each BN folds into its
conv; in training mode (``self.training``) BN runs on batch statistics and
updates its running statistics (``nn.layers.conv_bn``).  The conv trunk runs
on cuDNN on the GPU; it holds no hand kernel.
"""

import torch
from torch import nn

from .layers import conv_bn, max_pool_2d


class BasicBlock(nn.Module):
    def __init__(self, in_ch, out_ch, stride):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
                nn.BatchNorm2d(out_ch))

    def forward(self, x):
        t = self.training
        y = torch.relu(conv_bn(x, self.conv1, self.bn1, t))
        y = conv_bn(y, self.conv2, self.bn2, t)
        if self.downsample is not None:
            x = conv_bn(x, self.downsample[0], self.downsample[1], t)
        return torch.relu(x + y)


class ResNetTrunk(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(BasicBlock(64, 64, 1),
                                    BasicBlock(64, 64, 1))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2),
                                    BasicBlock(128, 128, 1))

    def forward(self, x, stem_weight=None):
        """``stem_weight`` replaces conv1's weight (the model folds the
        input normalization into it)."""
        y = torch.relu(conv_bn(x, self.conv1, self.bn1, self.training,
                               stem_weight))
        y = max_pool_2d(y)
        return self.layer2(self.layer1(y))
