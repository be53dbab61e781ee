"""The port stands alone and never falls back to the CPU on its own.

* No module of handyrl_tpu_torch, and not chip_smoke.py, imports jax, flax,
  optax or handyrl_tpu (checked on the source, by AST).
* Entry points run on the card unless the caller asks for the CPU; with no
  card they raise.
* The kernel wrappers take the plain version only for CPU tensors; for
  anything else they launch the kernel or raise.
"""

import ast
import importlib
from pathlib import Path

import pytest
import torch

from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import InferenceModel
from handyrl_tpu_torch.ops import cuda_build
from handyrl_tpu_torch.parallel import TrainContext
from handyrl_tpu_torch.runtime import Trainer

# the module: the ops package exports the function under the same name
fa = importlib.import_module("handyrl_tpu_torch.ops.flash_attention")

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
    checked = {str(p.relative_to(ROOT / "handyrl_tpu_torch")) for p in files[:-1]}
    assert len(files) > 30 and {
        "main.py", "agents.py", "envs/tictactoe.py", "envs/hungry_geese.py",
        "envs/parallel_tictactoe.py", "models/layers.py", "models/nets.py",
        "runtime/checkpoint.py", "runtime/evaluation.py", "runtime/inference_engine.py",
        "runtime/learner.py", "runtime/trainer.py", "runtime/worker.py",
        "runtime/connection.py", "runtime/server.py", "runtime/battle.py",
        "league/matchmaker.py", "envs/connect_four.py", "runtime/shm_batch.py",
        "runtime/_codec_build.py", "runtime/codec.py", "runtime/batch.py",
        "envs/vector_common.py", "envs/vector_tictactoe.py", "envs/vector_parallel_tictactoe.py",
        "envs/vector_hungry_geese.py", "envs/vector_geister.py", "runtime/device_rollout.py",
        "runtime/device_eval.py", "runtime/device_replay.py", "runtime/device_batch.py",
        "league/league.py", "league/learner.py", "envs/autovec.py",
        "utils/sanitizers.py", "parallel/mesh.py", "parallel/distributed.py",
        "parallel/health.py", "runtime/plane.py", "runtime/actor_host.py",
        "ops/ring_attention.py", "ops/flash_attention.py", "parallel/train_step.py",
        "models/transformer.py"} <= checked
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


@pytest.mark.parametrize("env_args,train_args", [
    ({"env": "Geister"}, dict(TRAIN_ARGS, burn_in_steps=2)),
    ({"env": "HungryGeese"}, dict(TRAIN_ARGS, turn_based_training=False, observation=False)),
    ({"env": "ParallelTicTacToe"}, dict(TRAIN_ARGS, turn_based_training=False)),
])
@pytest.mark.parametrize("entry", ["inference", "train_context"])
def test_new_nets_refuse_to_fall_back_to_cpu(monkeypatch, entry, env_args, train_args):
    """The DRC GeisterNet, GeeseNet and the simultaneous-move env take the
    same entry points: on the card, or on the CPU when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = make_env(env_args).net()
    build = {
        "inference": lambda device=None: InferenceModel(module, device=device),
        "train_context": lambda device=None: TrainContext(module, train_args, device=device),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    build(device="cpu")


@pytest.mark.parametrize("entry", ["device_rollout", "streaming_rollout", "make_device_rollout",
                                   "device_evaluator", "learner_device_planes", "device_replay",
                                   "device_stage", "learner_device_replay"])
def test_device_planes_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path, entry):
    """On-device self-play and evaluation run on the card; without one they
    raise, and run on the CPU only when asked."""
    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.runtime.device_eval import DeviceEvaluator
    from handyrl_tpu_torch.runtime.device_replay import DeviceEpisodeStage, DeviceReplay
    from handyrl_tpu_torch.runtime.device_rollout import (
        DeviceRollout, StreamingDeviceRollout, make_device_rollout,
    )
    from handyrl_tpu_torch.runtime.learner import Learner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ttt, geese = make_env({"env": "TicTacToe"}), make_env({"env": "HungryGeese"})
    args = {"observation": False, "compress_steps": 4, "gamma": 0.8}
    cfg = normalize_args({"env_args": {"env": "HungryGeese"}, "train_args": {
        "turn_based_training": False, "observation": False, "device_rollout_games": 8,
        "device_eval_games": 8, "worker": {"num_parallel": 1},
        "model_dir": str(tmp_path / "models"), "metrics_path": str(tmp_path / "m.jsonl")}})
    replay_cfg = normalize_args({"env_args": {"env": "HungryGeese"}, "train_args": dict(
        cfg["train_args"], device_replay=True)})
    build = {
        "device_rollout": lambda device=None: DeviceRollout(
            ttt.vector_env(), ttt.net(), args, 4, device=device),
        "streaming_rollout": lambda device=None: StreamingDeviceRollout(
            geese.vector_env(), geese.net(), args, 4, device=device),
        "make_device_rollout": lambda device=None: make_device_rollout(
            geese.vector_env(), geese.net(), args, 4, device=device),
        "device_evaluator": lambda device=None: DeviceEvaluator(
            geese.vector_env(), geese.net(), 4, device=device),
        "learner_device_planes": lambda device=None: Learner(cfg, device=device),
        "device_replay": lambda device=None: DeviceReplay(
            geese.vector_env(), geese.net(), dict(args, turn_based_training=False,
                                                  forward_steps=4), 4, slots=16, device=device),
        "device_stage": lambda device=None: DeviceEpisodeStage(
            geese.net(), dict(args, turn_based_training=False, forward_steps=4), device=device),
        "learner_device_replay": lambda device=None: Learner(replay_cfg, device=device),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    built = build(device="cpu")
    if entry in ("learner_device_planes", "learner_device_replay"):
        assert built._device_roll.device.type == built._device_eval.device.type == "cpu"
        if entry == "learner_device_replay":
            assert built._replay.device.type == built.trainer.ctx.device.type == "cpu"
        built.model_server.stop()
    elif entry in ("device_replay", "device_stage"):
        assert built.device.type == "cpu"
    else:
        assert next(built.module.parameters()).device.type == "cpu"


LOOP_CONFIG = {"env_args": {"env": "TicTacToe"},
               "train_args": {"batch_size": 4, "forward_steps": 4, "minimum_episodes": 2,
                              "update_episodes": 2, "epochs": 1, "worker": {"num_parallel": 1}}}


@pytest.mark.parametrize("entry", ["learner", "train_main", "eval_main", "main_train", "main_eval"])
def test_loop_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path, entry):
    """The learner loop and the CLI run on the card; without one they raise
    before anything starts, and run on the CPU only when asked."""
    import yaml

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.main import main
    from handyrl_tpu_torch.runtime.evaluation import eval_main
    from handyrl_tpu_torch.runtime.learner import Learner, train_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(LOOP_CONFIG))
    args = normalize_args(LOOP_CONFIG)
    call = {
        "learner": lambda device=None: Learner(args, device=device),
        "train_main": lambda device=None: train_main(args, device=device),
        "eval_main": lambda device=None: eval_main(args, ["random", "2", "1"], device=device),
        "main_train": lambda device=None: main(["--train"], device=device),
        "main_eval": lambda device=None: main(["--eval", "random", "2", "1"], device=device),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert not (tmp_path / "models").exists()
    if entry == "learner":
        call(device="cpu").model_server.stop()
    elif entry != "train_main":
        call(device="cpu")


@pytest.mark.parametrize("entry", ["train_server_main", "worker_main", "eval_client_main",
                                   "remote_model_server", "main_train_server", "main_worker",
                                   "main_eval_client"])
def test_remote_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path, entry):
    """The train server, the worker machine, the battle client and the
    machine's model server run on the card; without one they raise before
    they touch the network."""
    import yaml

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.main import main
    from handyrl_tpu_torch.runtime.battle import eval_client_main
    from handyrl_tpu_torch.runtime.learner import train_server_main
    from handyrl_tpu_torch.runtime.server import RemoteModelServer, worker_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(LOOP_CONFIG))
    args = normalize_args(LOOP_CONFIG)
    env = make_env(LOOP_CONFIG["env_args"])
    touched = []

    def fetch(model_id):
        touched.append(model_id)
        raise AssertionError("fetched before the device check")

    call = {
        "train_server_main": lambda: train_server_main(args),
        "worker_main": lambda: worker_main(args, ["main", "--worker", "1"]),
        "eval_client_main": lambda: eval_client_main(args, ["random", "127.0.0.1"], port=1),
        "remote_model_server": lambda: RemoteModelServer(env.net(), env, {}, fetch),
        "main_train_server": lambda: main(["--train-server"]),
        "main_worker": lambda: main(["--worker"]),
        "main_eval_client": lambda: main(["--eval-client", "random"]),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert not touched and not (tmp_path / "models").exists()


def test_kernel_wrapper_never_takes_the_plain_version_off_the_cpu():
    q = torch.zeros(1, 4, 1, 16, device="meta")
    km, sl = torch.ones(1, 4, device="meta"), torch.ones(1, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.masked_flash_attention(q, q, q, km, sl)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.masked_flash_kernel(torch.zeros(1, 4, 1, 16), *(torch.zeros(1, 4, 1, 16),) * 2,
                               torch.ones(1, 4), torch.ones(1))


def test_flash_wrapper_never_takes_the_plain_version_off_the_cpu():
    q = torch.zeros(1, 4, 1, 16, device="meta")
    launches = fa.FLASH.launches
    for causal in (True, False):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fa.flash_attention(q, q, q, causal)
        with pytest.raises(ValueError, match="CUDA tensors"):
            fa.flash_kernel(*(torch.zeros(1, 4, 1, 16),) * 3, causal)
    assert fa.FLASH.launches == launches


@pytest.mark.parametrize("kernel", ["MASKED_FLASH", "FLASH"])
def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path, kernel):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda path: False)
    shipped = getattr(fa, kernel)
    kernel = cuda_build.CudaKernel(shipped.source.name, shipped.symbol, [])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.fn()
    assert kernel.launches == 0 and not list(tmp_path.iterdir())


def _strided_views(layout, shape=(2, 8, 2, 16)):
    """q, k, v that are views in a layout the kernels do not read directly:
    unbound from a fused qkv projection, or transposed."""
    B, T, H, D = shape
    x = torch.randn(B, T, 3, H, D, generator=torch.Generator().manual_seed(0))
    if layout == "unbound_qkv":
        return x.unbind(2)
    return [y.transpose(1, 2).contiguous().transpose(1, 2) for y in x.unbind(2)]


@pytest.mark.parametrize("layout", ["unbound_qkv", "transposed"])
@pytest.mark.parametrize("op", ["flash_attention", "masked_flash_attention"])
def test_public_wrappers_take_any_layout(monkeypatch, op, layout):
    """The JAX ops take q, k, v in any layout; the public wrappers hand the
    kernel path contiguous copies (the raw launches refuse strided ones)."""
    q, k, v = _strided_views(layout)
    assert not any(x.is_contiguous() for x in (q, k, v))
    extra = (torch.ones(2, 8), torch.ones(2)) if op == "masked_flash_attention" else ()
    fn = getattr(fa, op)
    want = fn(*(x.contiguous() for x in (q, k, v)), *extra)
    fn_class = fa._MaskedFlashAttention if extra else fa._FlashAttention
    handed = []
    apply = fn_class.apply
    monkeypatch.setattr(fn_class, "apply", lambda *a: handed.extend(a[:3]) or apply(*a))
    got = fn(q, k, v, *extra)
    assert len(handed) == 3 and all(x.is_contiguous() for x in handed)
    assert torch.equal(got, want)


def test_both_kernels_share_one_source():
    assert fa.MASKED_FLASH.source == fa.FLASH.source
    assert fa.FLASH.source.name == "flash_attention.cu" and fa.FLASH.source.exists()
    assert fa.MASKED_FLASH.symbol != fa.FLASH.symbol


def test_head_dim_padding_round_trips_exactly():
    x = torch.randn(2, 8, 2, 24, generator=torch.Generator().manual_seed(0))
    assert [fa.kernel_head_dim(d) for d in (1, 16, 17, 24, 64, 65, 96, 100, 128)] == [
        16, 16, 32, 32, 64, 96, 96, 128, 128]
    padded = fa.pad_head_dim(x, fa.kernel_head_dim(24))
    assert padded.shape == (2, 8, 2, 32) and padded.is_contiguous()
    assert torch.equal(padded[..., :24], x) and not padded[..., 24:].any()
    assert fa.pad_head_dim(x, 24) is x
    assert torch.equal(fa._unpad(padded, 24), x) and fa._unpad(padded, 24).is_contiguous()
    with pytest.raises(ValueError, match="up to 128"):
        fa.kernel_head_dim(129)
    # what the JAX kernel takes, the port's kernels take: any D <= 128, fp16
    fa._check_kernel_inputs(*_qkv((2, 8, 2, 24)), torch.ones(2, 8), torch.ones(2))
    fa._check_kernel_inputs(*_qkv(dtype=torch.float16), torch.ones(2, 8), torch.ones(2))
    fa._check_qkv(*_qkv((2, 8, 2, 24), dtype=torch.float16))


def _qkv(shape=(2, 8, 2, 16), dtype=torch.float32):
    return [torch.zeros(shape, dtype=dtype) for _ in range(3)]


@pytest.mark.parametrize(
    "case,exc",
    [
        (lambda: (*_qkv(dtype=torch.float64), torch.ones(2, 8), torch.ones(2)), TypeError),
        (lambda: (*_qkv((2, 8, 2, 160)), torch.ones(2, 8), torch.ones(2)), ValueError),
        (lambda: (*_qkv(), torch.ones(2, 7), torch.ones(2)), ValueError),
        (lambda: (*_qkv(), torch.ones(2, 8), torch.ones(3)), ValueError),
        (lambda: (*_qkv(), torch.ones(2, 8, dtype=torch.float64), torch.ones(2)), ValueError),
        (lambda: (_qkv()[0].transpose(1, 2).contiguous().transpose(1, 2), *_qkv()[1:],
                  torch.ones(2, 8), torch.ones(2)), ValueError),
        (lambda: (torch.zeros(2, 8, 32), *_qkv()[1:], torch.ones(2, 8), torch.ones(2)), ValueError),
    ],
    ids=["fp64", "head_dim_160", "mask_shape", "slopes_shape", "mask_dtype", "strided_q", "rank3"],
)
def test_kernel_input_checks(case, exc):
    with pytest.raises(exc):
        fa._check_kernel_inputs(*case())


@pytest.mark.parametrize(
    "case,exc",
    [
        (lambda: _qkv(dtype=torch.float64), TypeError),
        (lambda: _qkv((2, 8, 2, 160)), ValueError),
        (lambda: (_qkv()[0], torch.zeros(2, 8, 2, 32), _qkv()[2]), ValueError),
        (lambda: (*_qkv()[:2], torch.zeros(2, 8, 2, 16, dtype=torch.bfloat16)), ValueError),
        (lambda: (_qkv()[0].transpose(1, 2).contiguous().transpose(1, 2), *_qkv()[1:]), ValueError),
        (lambda: (torch.zeros(2, 8, 32), *_qkv()[1:]), ValueError),
        (lambda: (*_qkv()[:2], torch.zeros(2, 8, 2, 16, device="meta")), ValueError),
    ],
    ids=["fp64", "head_dim_160", "k_shape", "v_dtype", "strided_q", "rank3", "v_device"],
)
def test_flash_kernel_input_checks(case, exc):
    with pytest.raises(exc):
        fa._check_qkv(*case())


def _misaligned_view(shape, dtype):
    """A contiguous (B, T, H, D) view whose data starts one element (2 or 4
    bytes) past an aligned allocation: as a view of x[1:] would."""
    flat = torch.arange(1 + torch.Size(shape).numel(), dtype=torch.float32).to(dtype)
    x = flat[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    return x


@pytest.mark.parametrize("D", [16, 24, 32, 64, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_misaligned_view_reaches_the_launch_aligned(dtype, D):
    """TMA reads from a 16-byte aligned base: what the raw launches hand the
    kernel (``kernel_operand``) starts on one, as a copy of a view that does
    not, padded to the kernel's head dim, with the view's values."""
    x = _misaligned_view((2, 5, 3, D), dtype)
    Dp = fa.kernel_head_dim(D)
    got = fa.kernel_operand(x, Dp)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert got.shape == (2, 5, 3, Dp) and got.dtype == dtype
    assert torch.equal(got[..., :D], x) and not got[..., D:].any()
    aligned = x.clone()
    assert aligned.data_ptr() % 16 == 0
    assert (fa.kernel_operand(aligned, Dp) is aligned) == (Dp == D)  # no copy when none is needed


@pytest.mark.parametrize("D", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_kernel_strides_are_whole_16_bytes(dtype, D):
    """Every stride the wrappers hand the kernel but D's own is a multiple of
    16 bytes (TMA's rule), at every instantiated head dim, from unpadded,
    padded and misaligned inputs alike."""
    for x in (torch.zeros(2, 7, 3, D, dtype=dtype), torch.zeros(2, 7, 3, D - 8, dtype=dtype),
              _misaligned_view((2, 7, 3, D), dtype)):
        got = fa.kernel_operand(x, fa.kernel_head_dim(x.shape[-1]))
        *outer, inner = got.stride()
        assert inner == 1 and got.shape[-1] == D
        assert all(s * got.element_size() % 16 == 0 for s in outer), (dtype, D, got.stride())
