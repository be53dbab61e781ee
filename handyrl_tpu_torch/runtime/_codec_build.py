"""Build-at-first-use loader for the codec's C accelerator.

Counterpart of ``handyrl_tpu/runtime/_codec_build.py``.  No install step:
``_codec_accel.c`` is compiled with the system compiler (``cc -O2 -shared
-fPIC -I<python include>``) into ``build/host/`` at the repo root and loaded
from there; later loads find the library already built.  The library's name
carries a hash of the source, so an edited source is rebuilt and a stale
library is never loaded.  Concurrent builders (test workers, processes
starting together) compile to a temp file of their own and rename it into
place atomically.

Any failure raises; ``codec.get_accel()`` then runs the pure-Python codec.
A process that forks batchers loads the library before it forks, so the
children never compile.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().with_name("_codec_accel.c")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"

# every symbol the runtime calls: the wire codec pair and the columnar fill
# of runtime/batch.py.  A hand-copied or truncated library must fail here,
# loudly, not as an AttributeError deep in a batcher process
_REQUIRED_SYMBOLS = ("init", "dumps", "loads", "fill_rows", "fill_column")


def library_path(src: Path = SRC, build_dir: Path = BUILD_DIR) -> Path:
    """Per-ABI, per-source-content name: ``_codec_accel.<SOABI>.<sha>.so``."""
    tag = sysconfig.get_config_var("SOABI") or "abi3"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return build_dir / f"{src.stem}.{tag}.{digest}.so"


def _compile(src: Path, so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    cc = os.environ.get("CC", "cc")
    include = sysconfig.get_paths()["include"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(so.parent))
    os.close(fd)
    try:
        proc = subprocess.run(
            [cc, "-O2", "-shared", "-fPIC", f"-I{include}", str(src), "-o", tmp],
            capture_output=True, text=True, timeout=120,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"{cc} failed on {src.name}:\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: racing builders both win
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(src: Path = SRC, build_dir: Path = BUILD_DIR):
    """The accelerator module, compiled first if no library of this source
    exists; raises on any failure."""
    so = library_path(src, build_dir)
    if not so.exists():
        _compile(src, so)
    spec = importlib.util.spec_from_file_location("handyrl_tpu_torch.runtime._codec_accel", so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [s for s in _REQUIRED_SYMBOLS if not hasattr(mod, s)]
    if missing:
        raise ImportError(f"_codec_accel at {so} lacks {missing}; rebuild from {src.name}")
    return mod
