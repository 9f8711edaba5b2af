"""The model configuration, as the JAX package defines it.

A field-for-field copy of ``rel_pose_tpu/config.py:ModelConfig`` (same
names, defaults and derived sizes; ``tests/test_torch_model.py`` pins the
two equal).  The port keeps its own copy so that it and ``chip_smoke.py``
import nothing of the JAX package: the GPU host runs them without it.  The
argparse bridge and ``TrainConfig`` come with the CLIs and training.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture flags, mirroring the reference's model args."""
    fusion_transformer: bool = True
    transformer_depth: int = 6
    no_pos_encoding: bool = False
    noess: bool = False
    cross_features: bool = False
    use_single_softmax: bool = False
    l1_pos_encoding: bool = False
    fc_hidden_size: int = 512
    pool_size: int = 60

    # architecture constants (src/model.py:19-23,37)
    total_num_features: int = 192
    feature_height: int = 24
    feature_width: int = 24
    num_heads: int = 3
    num_images: int = 2
    pose_size: int = 7

    # activation dtype over fp32 master weights: 'float32' or 'bfloat16'
    compute_dtype: str = "float32"

    @property
    def feature_resolution(self):
        return (self.feature_height, self.feature_width)

    @property
    def num_patches(self):
        return self.feature_height * self.feature_width

    @property
    def head_dim(self):
        return self.total_num_features // self.num_heads

    @property
    def pos_enc(self):
        """Width of the positional block appended to v (src/model.py:58-60)."""
        return 0 if (self.no_pos_encoding or self.noess) else 6

    @property
    def pool_feat1(self):
        return min(96, 4 * self.pool_size)

    @property
    def regressor_input_dim(self):
        """H, the flattened feature width feeding the pose MLP
        (src/model.py:61-74)."""
        if self.noess:
            return self.num_patches * 43
        if self.fusion_transformer:
            return int(self.num_heads * 2 * (self.head_dim + self.pos_enc)
                       * self.head_dim)
        return self.pool_size * self.num_patches
