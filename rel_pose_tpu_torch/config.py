"""The model and training configuration, as the JAX package defines it.

A field-for-field copy of ``rel_pose_tpu/config.py``: ``ModelConfig`` (same
names, defaults and derived sizes), ``TrainConfig`` and the argparse bridge
``add_model_flags`` / ``model_config_from_args`` (``tests/test_torch_model.py``
pins them equal).  The port keeps its own copy so that it and
``chip_smoke.py`` import nothing of the JAX package: the GPU host runs them
without it.
"""

import argparse
import dataclasses
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


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference defaults, train.py:219-229)."""
    w_tr: float = 10.0
    w_rot: float = 10.0
    warmup: int = 10000
    batch: int = 1           # per-replica batch (DDP semantics)
    steps: int = 120000
    lr: float = 5e-4
    clip: float = 2.5
    weight_decay: float = 1e-5
    num_workers: int = 4
    name: str = "bla"
    dataset: str = "matterport"
    datapath: str = ""
    streetlearn_interiornet_type: str = ""
    use_mini_dataset: bool = False
    ckpt_every: int = 10000
    seed: int = 0


_MODEL_FLAGS = [
    ("no_pos_encoding", "store_true"),
    ("noess", "store_true"),
    ("cross_features", "store_true"),
    ("use_single_softmax", "store_true"),
    ("l1_pos_encoding", "store_true"),
]


def add_model_flags(parser: argparse.ArgumentParser, fusion_default=False):
    """Install the reference's model flags on an argparse parser."""
    for name, action in _MODEL_FLAGS:
        parser.add_argument(f"--{name}", action=action)
    parser.add_argument("--fusion_transformer", action="store_true",
                        default=fusion_default)
    parser.add_argument("--fc_hidden_size", type=int, default=512)
    parser.add_argument("--pool_size", type=int, default=60)
    parser.add_argument("--transformer_depth", type=int, default=6)
    parser.add_argument("--compute_dtype", default="float32",
                        choices=("float32", "bfloat16"))
    return parser


def model_config_from_args(args) -> ModelConfig:
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kwargs = {k: v for k, v in vars(args).items() if k in fields}
    return ModelConfig(**kwargs)
