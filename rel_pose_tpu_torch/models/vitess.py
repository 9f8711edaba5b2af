"""ViTEss forward: an image pair -> the SE(3) relative pose.

Counterpart of ``rel_pose_tpu/models/vitess.py:124-344`` for every
configuration: the flagship (Essential Matrix Module, quadratic positional
encoding), the paper's ablations of the Essential Matrix Module
(``ModelConfig`` flags ``use_single_softmax``, ``cross_features``,
``no_pos_encoding``, ``l1_pos_encoding``), --noess
(``ModelConfig(noess=True)``, where those four flags have no effect) and
the no-fusion baseline (``ModelConfig(fusion_transformer=False)``, the
training CLI's default):

  uint8 or float (B, 2, 3, H, W) raw BGR images, (B, 2, 4) intrinsics or
  None (the reference's initial positional tables)
  -> nearest resize to 224, mean subtraction (1/std folded into conv1)
  -> ResNet-18 trunk through layer2 -> k=5 extractor block: 576 tokens x 192
  -> depth-1 self-attention blocks (``ops.vit_stack``, hand kernels on CUDA)
  -> essential cross block (``ops.essential``, hand kernels on CUDA) ->
     LayerNorm -> (B, 2 x 3 x e x 64), e = 70, or 64 without positions
  -> --noess: cross block x + attn(LN(x)) (``ops.attention``, hand kernels
     on CUDA), x + MLP(LN(x)) -> LayerNorm -> (B, 24, 24, 2 x 192)
     row-major -> ``pool_attn`` 1x1 conv head 384 -> 96 -> 43 -> (B, 24,768)
  -> no fusion: the extractor's first 96 channels, (2B, 576, 96) reshaped
     row-major to (B, 24, 24, 192) -> ``pool_transformer_output`` 1x1 conv
     head 192 -> 96 -> pool_size -> (B, 60 x 576); no hand kernel runs
  -> fp32 pose regressor -> ``normalize_preds`` -> (B, 2, 7)

Attribute names reproduce the reference state-dict keys
(``rel_pose_tpu/utils/convert.py:95-164``).  The module is built without
initializing its parameters; load a state dict (``utils.convert`` or
``nn.init.seeded_state_dict``) before use.  ``cfg.compute_dtype`` picks
fp32 or bf16 activations over fp32 master weights.  ``kernels=False`` runs
the plain PyTorch versions of the kernel-backed stages on any device,
differentiated by autograd: the oracle the kernels are held against.
Construction applies the fp32 precision knob (``utils.precision``:
``$RELPOSE_MATMUL_PRECISION``, full fp32 by default).

The model is built in eval mode.  In training mode (``model.train()``) the
BatchNorms run on batch statistics and move their running statistics, and
a forward under autograd reaches the stages' ``autograd.Function``s
(``ops.vit_stack``, ``ops.essential_block`` or ``ops.attention``).  Eval
callers run it under ``torch.no_grad()`` or ``torch.inference_mode()``,
where no stage keeps anything for a backward.

``forward(..., remat=True)`` rematerializes the training forward, as the
JAX package's ``make_loss_fn(remat=True)`` does: each stage of
:data:`REMAT_STAGES` runs under a non-reentrant
``torch.utils.checkpoint``, which keeps the stage's input, frees what its
ops and autograd Functions saved for the backward (the ViT stack's stash,
the essential block's and #7's residuals, the trunk's activations), and
runs the stage again when the backward reaches it.  The recompute leaves
the BatchNorm running statistics alone (``nn.layers.
frozen_running_stats``), so a step moves them once; the gradients are
those of the plain forward.
"""

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.extractor import ResidualBlock
from ..nn.layers import (conv_bn, frozen_running_stats, layernorm, linear,
                         mlp)
from ..nn.resnet import ResNetTrunk
from ..nn.transformer import Block, Mlp
from ..ops.attention import fused_mhsa, mhsa_reference
from ..ops.essential import (essential_cross_attention_pair,
                             noess_cross_attention)
from ..ops.essential_block import (essential_block_pair_reference,
                                   fused_essential_block_pair)
from ..ops.image import (nearest_resize, normalization_constants,
                         scale_intrinsics)
from ..ops.posenc import (l1_positional_encoding,
                          quadratic_positional_encoding)
from ..ops.vit_stack import (fused_vit_stack, stack_block_params,
                             vit_stack_reference)
from ..utils.precision import apply_matmul_precision


#: the stages that ``forward(remat=True)`` checkpoints: every stage that
#: holds parameters but the fp32 regressor (``pre`` and ``tokens`` hold
#: none; the regressor saves about 0.1 MB a pair)
REMAT_STAGES = ("stem", "layer1", "layer2", "extractor", "vit", "cross",
                "head")


def _remat_contexts():
    """``context_fn`` of a checkpointed stage: the forward as it is, the
    recompute without moving BatchNorm's running statistics."""
    return contextlib.nullcontext(), frozen_running_stats()


class CrossAttention(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dim = cfg.total_num_features
        self.qkv = nn.Linear(dim, 3 * dim)
        if cfg.noess:
            self.proj = nn.Linear(dim, dim)
        else:
            # h (d + 6) -> C, or h d -> C without positions
            # (rel_pose_tpu/ops/essential.py:39-41)
            pos = 0 if cfg.no_pos_encoding else 6 * cfg.num_heads
            self.proj_fundamental = nn.Linear(dim + pos, dim)


class CrossBlock(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dim = cfg.total_num_features
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.cross_attn = CrossAttention(cfg)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)


class FusionTransformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        C = cfg.total_num_features
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches, C))
        self.blocks = nn.ModuleList(
            [Block(C) for _ in range(cfg.transformer_depth - 1)]
            + [CrossBlock(cfg)])
        self.norm = nn.LayerNorm(C, eps=1e-6)


def normalize_preds(Gs, pose_preds):
    """Re-normalize the quaternion block with floor max(|q|, 0.01) and pin
    pose 0 to the input ``Gs`` (``models/vitess.py:270-278``)."""
    q = pose_preds[..., 3:]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(0.01)
    normed = torch.cat([pose_preds[..., :3], q], dim=-1)
    return torch.cat([Gs[:, :1], normed[:, 1:]], dim=1)


def _conv_pool(c_in, c_mid, c_out):
    """The reference's 1x1-conv pooling head: conv, BatchNorm, ReLU, conv,
    BatchNorm (state-dict indices 0, 1, 3, 4)."""
    return nn.Sequential(nn.Conv2d(c_in, c_mid, 1), nn.BatchNorm2d(c_mid),
                         nn.ReLU(), nn.Conv2d(c_mid, c_out, 1),
                         nn.BatchNorm2d(c_out))


def _conv_pool_apply(head, x, training):
    """``_conv_pool_head`` (``rel_pose_tpu/models/vitess.py:258-267``)."""
    y = torch.relu(conv_bn(x, head[0], head[1], training))
    return conv_bn(y, head[3], head[4], training)


class ViTEss(nn.Module):
    def __init__(self, cfg, device="cuda", kernels=True):
        super().__init__()
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(
                f"compute_dtype {cfg.compute_dtype!r}: float32 or bfloat16")
        self.cfg = cfg
        self.kernels = kernels
        apply_matmul_precision()
        C = cfg.total_num_features
        with torch.device("meta"):
            self.resnet = ResNetTrunk()
            self.extractor_final_conv = ResidualBlock(
                128, C, 28 - cfg.feature_height + 1)
            if cfg.fusion_transformer:
                self.fusion_transformer = FusionTransformer(cfg)
            else:
                # src/model.py:64-70: 1x1 convs C -> pool_feat1 -> pool_size
                self.pool_transformer_output = _conv_pool(
                    C, cfg.pool_feat1, cfg.pool_size)
            if cfg.noess:
                # src/model.py:72-81: 1x1 convs 2C -> pool_feat1 -> 43
                self.pool_attn = _conv_pool(2 * C, cfg.pool_feat1, 43)
            H, H2 = cfg.regressor_input_dim, cfg.fc_hidden_size
            self.pose_regressor = nn.Sequential(
                nn.Linear(H, H2), nn.ReLU(), nn.Linear(H2, H2), nn.ReLU(),
                nn.Linear(H2, cfg.num_images * cfg.pose_size))
        self.to_empty(device=device)
        self.eval()

    @property
    def compute_dtype(self):
        return (torch.bfloat16 if self.cfg.compute_dtype == "bfloat16"
                else torch.float32)

    def stages(self, image_shape, intrinsics=None, Gs=None):
        """``[(name, fn)]``: the forward on images of ``image_shape`` (B, 2,
        3, H, W) cut into stages, which ``forward`` applies in order to the
        images (``tools.bench_stages`` times them one by one):

          pre        reshape, nearest resize to 224, cast, mean subtraction
          stem       conv1 with the normalization folded in, BN, ReLU,
                     max-pool
          layer1, layer2, extractor   the ResNet layers, the k=5 block
          tokens     (2B, C, 24, 24) -> (2B, 576, C)
          vit        the ViT stack (kernel #1 on CUDA)
          cross      the essential cross block, norm2 and MLP, the final
                     LayerNorm; or --noess's head
          regress    the fp32 pose regressor and ``normalize_preds``

        The no-fusion baseline has ``head`` in place of ``vit`` and
        ``cross``."""
        B = image_shape[0]
        out = [("pre", self._pre), ("stem", self._stem),
               ("layer1", self.resnet.layer1), ("layer2", self.resnet.layer2),
               ("extractor", self.extractor_final_conv),
               ("tokens", self._to_tokens)]
        if self.cfg.fusion_transformer:
            out += [("vit", self._vit),
                    ("cross", lambda x: self._cross(x, intrinsics,
                                                    image_shape))]
        else:
            out.append(("head", self._no_fusion_head))
        return out + [("regress", lambda y: self._regress(y, B, Gs))]

    def forward(self, images, intrinsics=None, Gs=None, remat=False):
        """``images (B, 2, 3, H, W)`` uint8 or float raw BGR 0-255,
        ``intrinsics (B, 2, 4)`` [fx, fy, cx, cy] at H x W, or None ->
        ``(B, 2, 7)`` fp32 poses (tx ty tz qx qy qz qw).  Pose 0 is taken
        from ``Gs (B, 2, 7)``, the identity by default.  ``remat``
        checkpoints each of :data:`REMAT_STAGES` (the module docstring): less
        memory held for the backward, one more forward of those stages in
        it."""
        x = images
        for name, stage in self.stages(images.shape, intrinsics, Gs):
            if remat and name in REMAT_STAGES:
                x = checkpoint(stage, x, use_reentrant=False,
                               context_fn=_remat_contexts)
            else:
                x = stage(x)
        return x

    def _pre(self, images):
        """(B, 2, 3, H, W) -> (2B, 3, 224, 224) in the compute dtype, less
        the mean."""
        dt = self.compute_dtype
        x = images.reshape((-1,) + images.shape[2:])
        x = nearest_resize(x, 224).to(dt)
        return x - normalization_constants(dt, x.device)[0]

    def _stem(self, x):
        inv_std = normalization_constants(self.compute_dtype, x.device)[1]
        return self.resnet.stem(x, self.resnet.conv1.weight.flip(1) * inv_std)

    @staticmethod
    def _to_tokens(x):
        x = x.reshape(x.shape[0], x.shape[1], -1)
        return x.transpose(1, 2).contiguous()

    def _vit(self, x):
        """The fusion transformer's ViT stack on ``x (2B, N, C)``."""
        ft = self.fusion_transformer
        stacked = stack_block_params(ft.blocks[:-1], self.compute_dtype)
        vit = fused_vit_stack if self.kernels else vit_stack_reference
        return vit(x, stacked, self.cfg.num_heads, pos=ft.pos_embed)

    def _cross(self, x, intrinsics, image_shape):
        """The essential cross block and the final norm, or --noess's head;
        ``x (2B, N, C)`` -> features to flatten."""
        cfg, ft = self.cfg, self.fusion_transformer
        B = x.shape[0] // 2
        N, C, heads = cfg.num_patches, cfg.total_num_features, cfg.num_heads
        cb = ft.blocks[-1]
        if cfg.noess:
            return self._noess_head(x, cb)
        intr = (None if intrinsics is None else scale_intrinsics(
            intrinsics.float(), image_shape, cfg.feature_resolution))
        f1, f2 = essential_cross_attention_pair(
            x.reshape(B, 2, N, C), (cb.norm1.weight, cb.norm1.bias),
            (cb.cross_attn.qkv.weight, cb.cross_attn.qkv.bias),
            (cb.cross_attn.proj_fundamental.weight,
             cb.cross_attn.proj_fundamental.bias),
            self._positional(intr, B, x.device), heads,
            cross_features=cfg.cross_features,
            use_single_softmax=cfg.use_single_softmax,
            block=(fused_essential_block_pair if self.kernels
                   else essential_block_pair_reference))
        fund = torch.stack([f1, f2], dim=1).reshape(2 * B, -1, C)
        fund = fund + mlp(layernorm(fund, cb.norm2.weight, cb.norm2.bias),
                          cb.mlp.fc1, cb.mlp.fc2)
        return layernorm(fund, ft.norm.weight, ft.norm.bias)

    def _regress(self, y, batch, Gs):
        """Features of ``batch`` pairs -> ``(batch, 2, 7)`` fp32 poses."""
        cfg = self.cfg
        y = y.reshape(batch, -1).float()
        pr = self.pose_regressor
        y = torch.relu(linear(y, pr[0].weight, pr[0].bias))
        y = torch.relu(linear(y, pr[2].weight, pr[2].bias))
        y = linear(y, pr[4].weight, pr[4].bias)
        pose_preds = y.reshape(batch, cfg.num_images, cfg.pose_size)
        if Gs is None:
            Gs = torch.zeros_like(pose_preds)
            Gs[..., 6] = 1.0
        return normalize_preds(Gs, pose_preds)

    def _no_fusion_head(self, x):
        """The no-fusion baseline (``rel_pose_tpu/models/vitess.py:186-187,
        315-323``): the first C / 2 channels of ``x (2B, N, C)``, reshaped
        row-major to (B, 24, 24, C) as the reference does (so one image's
        tokens span two rows of the grid), then ``pool_transformer_output``
        -> ``(B, pool_size, 24, 24)``."""
        cfg = self.cfg
        f = x[..., :cfg.total_num_features // 2].reshape(
            -1, cfg.feature_height, cfg.feature_width,
            cfg.total_num_features)
        return _conv_pool_apply(self.pool_transformer_output,
                                f.permute(0, 3, 1, 2), self.training)

    def _positional(self, intr, batch, device):
        """The positional table of ``_positional``
        (``rel_pose_tpu/models/vitess.py:205-210``): None under
        ``no_pos_encoding`` (which wins over ``l1_pos_encoding``), else the
        L1 or the quadratic table, ``(B, N, 6)``."""
        cfg = self.cfg
        if cfg.no_pos_encoding:
            return None
        fn = (l1_positional_encoding if cfg.l1_pos_encoding
              else quadratic_positional_encoding)
        return fn(cfg.num_patches, intr, batch=batch, device=device)

    def _noess_head(self, x, cb):
        """The --noess cross block, final norm and ``pool_attn``
        (``rel_pose_tpu/models/vitess.py:247-255,325-332``): ``x (2B, N,
        C)`` -> ``(B, 43, 24, 24)``."""
        cfg, ft = self.cfg, self.fusion_transformer
        two_b, N, C = x.shape
        xp = x.reshape(-1, 2, N, C)
        ln1 = (cb.norm1.weight, cb.norm1.bias)
        y1, y2 = noess_cross_attention(
            layernorm(xp[:, 0], *ln1), layernorm(xp[:, 1], *ln1),
            (cb.cross_attn.qkv.weight, cb.cross_attn.qkv.bias),
            (cb.cross_attn.proj.weight, cb.cross_attn.proj.bias),
            cfg.num_heads,
            attention=fused_mhsa if self.kernels else mhsa_reference)
        x = x + torch.stack([y1, y2], dim=1).reshape(two_b, N, C)
        x = x + mlp(layernorm(x, cb.norm2.weight, cb.norm2.bias),
                    cb.mlp.fc1, cb.mlp.fc2)
        f = layernorm(x, ft.norm.weight, ft.norm.bias)
        # (2B, N, C) -> (B, 24, 24, 2C) row-major, as the JAX package
        f = f.reshape(two_b // 2, cfg.feature_height, cfg.feature_width, -1)
        return _conv_pool_apply(self.pool_attn, f.permute(0, 3, 1, 2),
                                self.training)
