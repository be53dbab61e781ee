"""The port stands alone and never falls back to the CPU on its own.

* No module of handyrl_tpu_torch, and not chip_smoke.py, imports jax, flax,
  optax or handyrl_tpu (checked on the source, by AST).
* Entry points run on the card unless the caller asks for the CPU; with no
  card they raise.
* The kernel wrapper takes the plain version only for CPU tensors; for
  anything else it launches the kernel or raises.
"""

import ast
from pathlib import Path

import pytest
import torch

from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import InferenceModel
from handyrl_tpu_torch.ops import cuda_build
from handyrl_tpu_torch.ops import flash_attention as fa
from handyrl_tpu_torch.parallel import TrainContext
from handyrl_tpu_torch.runtime import Trainer

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "handyrl_tpu"}
ENV_ARGS = {"env": "Geister", "net": "transformer",
            "net_args": {"d_model": 16, "n_heads": 2, "n_layers": 1, "memory_len": 4}}
TRAIN_ARGS = {"observation": True, "turn_based_training": True, "burn_in_steps": 0,
              "maximum_episodes": 10, "lr_scale": 1.0, "batch_size": 2, "forward_steps": 8}


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "handyrl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & FORBIDDEN) for p in files}
    assert not {k: v for k, v in offenders.items() if v}


@pytest.mark.parametrize("entry", ["inference", "train_context", "trainer"])
def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = make_env(ENV_ARGS).net()
    build = {
        "inference": lambda device=None: InferenceModel(module, device=device),
        "train_context": lambda device=None: TrainContext(module, TRAIN_ARGS, device=device),
        "trainer": lambda device=None: Trainer(TRAIN_ARGS, module, device=device),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    build(device="cpu")  # asked for: fine


def test_kernel_wrapper_never_takes_the_plain_version_off_the_cpu():
    q = torch.zeros(1, 4, 1, 16, device="meta")
    km, sl = torch.ones(1, 4, device="meta"), torch.ones(1, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.masked_flash_attention(q, q, q, km, sl)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.masked_flash_kernel(torch.zeros(1, 4, 1, 16), *(torch.zeros(1, 4, 1, 16),) * 2,
                               torch.ones(1, 4), torch.ones(1))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda path: False)
    kernel = cuda_build.CudaKernel(fa.MASKED_FLASH.source.name, "masked_flash_forward", [])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.fn()
    assert kernel.launches == 0 and not list(tmp_path.iterdir())


def _qkv(shape=(2, 8, 2, 16), dtype=torch.float32):
    return [torch.zeros(shape, dtype=dtype) for _ in range(3)]


@pytest.mark.parametrize(
    "case,exc",
    [
        (lambda: (*_qkv(dtype=torch.float16), torch.ones(2, 8), torch.ones(2)), TypeError),
        (lambda: (*_qkv((2, 8, 2, 24)), torch.ones(2, 8), torch.ones(2)), ValueError),
        (lambda: (*_qkv(), torch.ones(2, 7), torch.ones(2)), ValueError),
        (lambda: (*_qkv(), torch.ones(2, 8), torch.ones(3)), ValueError),
        (lambda: (*_qkv(), torch.ones(2, 8, dtype=torch.float64), torch.ones(2)), ValueError),
        (lambda: (_qkv()[0].transpose(1, 2).contiguous().transpose(1, 2), *_qkv()[1:],
                  torch.ones(2, 8), torch.ones(2)), ValueError),
        (lambda: (torch.zeros(2, 8, 32), *_qkv()[1:], torch.ones(2, 8), torch.ones(2)), ValueError),
    ],
    ids=["fp16", "head_dim_24", "mask_shape", "slopes_shape", "mask_dtype", "strided_q", "rank3"],
)
def test_kernel_input_checks(case, exc):
    with pytest.raises(exc):
        fa._check_kernel_inputs(*case())
