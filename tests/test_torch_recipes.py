"""The paper's recipes on the PyTorch port (``scripts/torch/*.sh``) on the
CPU.

Each of the ten scripts runs under ``bash`` with a stand-in ``python`` on
``PATH`` that writes its arguments to a file, the data and checkpoint
variables unset, and ``--device cpu`` given to the script (which appends
its arguments to the command).  What must hold: the script calls the
port's counterpart of its JAX script (``cli.train`` for ``train.py``,
``cli.test_matterport`` and ``cli.test_streetlearn_interiornet`` for the
eval scripts) with the JAX script's arguments, in their order, then
``--device cpu``; and the argument list parses in the port's CLI and
passes the checks it makes before it touches data: the training CLI's
``check_args`` (one process on the CPU), the model configuration (the
flagship at depth 6), the eval CLIs' device and, for InteriorNet and
StreetLearn, the metadata they select.
"""

import os
import pathlib
import stat
import subprocess

import pytest

from rel_pose_tpu_torch.cli import test_matterport as tm
from rel_pose_tpu_torch.cli import test_streetlearn_interiornet as tsi
from rel_pose_tpu_torch.cli import train as cli
from rel_pose_tpu_torch.cli._eval import resolve_device
from rel_pose_tpu_torch.config import model_config_from_args

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"
DATASETS = ("matterport", "interiornet", "interiornet_t", "streetlearn",
            "streetlearn_t")
RECIPES = [f"{kind}_{d}" for kind in ("train", "eval") for d in DATASETS]
ENTRY = {"train.py": "rel_pose_tpu_torch.cli.train",
         "test_matterport.py": "rel_pose_tpu_torch.cli.test_matterport",
         "test_streetlearn_interiornet.py":
             "rel_pose_tpu_torch.cli.test_streetlearn_interiornet"}


def script_argv(script, tmp_path, *args):
    """The arguments ``script`` gives ``python``."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    stub = bin_dir / "python"
    stub.write_text('#!/bin/sh\nfor a in "$@"; do printf "%s\\n" "$a"; '
                    'done > "$RECIPE_ARGS"\n')
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    out = tmp_path / "argv.txt"
    env = {k: v for k, v in os.environ.items() if k not in (
        "MATTERPORT_PATH", "INTERIORNET_STREETLEARN_PATH", "CKPT")}
    env.update(PATH=f"{bin_dir}{os.pathsep}{env.get('PATH', '')}",
               RECIPE_ARGS=str(out))
    subprocess.run(["bash", str(script), *args], env=env, cwd=tmp_path,
                   check=True, timeout=60)
    return out.read_text().splitlines()


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_parses_in_the_port(name, tmp_path):
    jax_argv = script_argv(SCRIPTS / f"{name}.sh", tmp_path)
    argv = script_argv(SCRIPTS / "torch" / f"{name}.sh", tmp_path,
                       "--device", "cpu")
    assert argv[:2] == ["-m", ENTRY[jax_argv[0]]]
    assert argv[2:] == jax_argv[1:] + ["--device", "cpu"]
    argv = argv[2:]
    if name.startswith("train"):
        args = cli.build_parser().parse_args(argv)
        assert cli.check_args(args) == 1
        assert args.name == name[len("train_"):] and args.batch == 6
    else:
        module = tm if name == "eval_matterport" else tsi
        args = module.build_parser().parse_args(argv)
        assert resolve_device(args.device, module.PROG).type == "cpu"
        assert args.ckpt == f"pretrained_models/{name[len('eval_'):]}.pth"
        if module is tsi:
            meta, _, _ = tsi.select_metadata(
                args.dataset, args.streetlearn_interiornet_type)
            assert ("T/" in meta) == name.endswith("_t")
    cfg = model_config_from_args(args)
    assert cfg.fusion_transformer and cfg.transformer_depth == 6
    assert args.datapath == ("matterport" if "matterport" in name
                             else "data")
