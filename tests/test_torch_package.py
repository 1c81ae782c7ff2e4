"""The port as a package: it imports neither JAX nor the JAX package,
its entry points run on the GPU unless the caller asks for the CPU,
and ``chip_smoke.py`` refuses to run without a GPU or without the
repository around it."""
import importlib
import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch import serve as launch
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import DecoderLM

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                       re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_sources_import_neither_jax_nor_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert {"repro_torch.serve.scheduler", "repro_torch.models.lm",
            "repro_torch.kernels.paged_attention.ops",
            "repro_torch.kernels.gemm_dataflow.ops",
            "repro_torch.kernels.block_sparse.ops",
            "repro_torch.kernels.lut_activation.ops",
            "repro_torch.launch.serve", "repro_torch.launch.train",
            "repro_torch.train.step", "repro_torch.train.optimizer",
            "repro_torch.data.pipeline", "repro_torch.checkpoint.ckpt",
            "repro_torch.runtime.driver", "repro_torch.runtime.elastic",
            "repro_torch.runtime.straggler"} <= set(mods)
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_modules_import_without_building_kernels():
    for m in _modules():
        importlib.import_module(m)
    from repro_torch.kernels import build
    assert not build._libs


def test_entry_points_default_to_the_gpu():
    cfg = configs.get_smoke("qwen3-0.6b")
    if torch.cuda.is_available():
        assert DecoderLM(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecoderLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--arch", "qwen3-0.6b", "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps",
                           "1"])
    from repro_torch.data import SyntheticPipeline
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticPipeline(cfg, 1, 4).device_batch(0)
    assert DecoderLM(cfg, device="cpu").device.type == "cpu"


def test_unported_configs_raise():
    """Every configuration the reference builds is ported; what it does
    not know raises instead of computing something else: an unknown
    block kind, an encoder-decoder given to the decoder class, an
    unknown arch."""
    import dataclasses
    cfg = dataclasses.replace(configs.get_smoke("qwen3-0.6b"),
                              block_pattern=("mamba",))
    with pytest.raises(ValueError, match="mamba"):
        DecoderLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        DecoderLM(configs.get_smoke("whisper-tiny"), device="cpu")
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("gpt-17")


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_a_gpu_or_the_repository(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs for real there")
    out = _smoke(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
