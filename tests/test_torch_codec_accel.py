"""The port's C codec accelerator (runtime/_codec_accel.c, built by
runtime/_codec_build.py) against the JAX package's codec, on the CPU.

Its bytes equal the JAX pure-Python specification's and the JAX
accelerator's, on episodes of every env and on seeded random structures;
each decodes the other's bytes.  The depth and u32-length errors are
CodecError.  The library is built under build/host/, rebuilt when its
source changes, and refused when a symbol is missing.  All exact: the
codec moves bytes.
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from handyrl_tpu.runtime import codec as jax_codec
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import InferenceModel, RandomModel
from handyrl_tpu_torch.runtime import Generator, codec
from handyrl_tpu_torch.runtime import _codec_build

ROOT = Path(__file__).resolve().parent.parent
# env args and the generator's args of each env
ENVS = {
    "TicTacToe": ({"env": "TicTacToe"}, {"observation": False}),
    "Geister": ({"env": "Geister"}, {"observation": True}),
    "HungryGeese": ({"env": "HungryGeese"}, {"observation": False}),
    "ParallelTicTacToe": ({"env": "ParallelTicTacToe"}, {"observation": False}),
    "ConnectFour": ({"env": "ConnectFour"}, {"observation": False}),
}


@pytest.fixture(scope="module")
def accel():
    acc = codec.get_accel()
    assert acc is not None, "the codec accelerator did not build on this Linux host"
    return acc


def _episodes(name, n=2, seed=0):
    env_args, gen_args = ENVS[name]
    env = make_env(env_args)
    env.reset()
    player = env.players()[0]
    out = RandomModel.from_model(InferenceModel(env.net(), device="cpu"), env.observation(player))
    gen = Generator(env, dict(gen_args, gamma=0.8, compress_steps=4))
    random.seed(seed)
    eps = [gen.generate({p: out for p in env.players()}, {"player": env.players()})
           for _ in range(n)]
    return [e for e in eps if e is not None]


def _eq(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in a)
    return a == b and type(a) is type(b)


def test_accelerator_is_built_under_build_host(accel):
    so = Path(accel.__file__)
    assert so.parent == ROOT / "build" / "host"
    assert so == _codec_build.library_path()
    assert codec.dumps({"x": 1}) == accel.dumps({"x": 1})


@pytest.mark.parametrize("name", sorted(ENVS))
def test_episode_bytes_equal_the_jax_codecs(accel, name):
    """An episode and each of its decoded blocks: the port's C bytes equal
    the JAX specification's and the JAX accelerator's, and every decoder
    reads every encoder's bytes back to the same columns."""
    from handyrl_tpu_torch.runtime.replay import decompress_block

    jax_accel = jax_codec.get_accel()
    for ep in _episodes(name):
        blocks = [decompress_block(b) for b in ep["blocks"]]
        for obj in [ep] + blocks:
            raw = accel.dumps(obj)
            assert raw == jax_codec.py_dumps(obj) == codec.py_dumps(obj)
            if jax_accel is not None:
                assert raw == jax_accel.dumps(obj)
            for back in (accel.loads(raw), codec.py_loads(raw), jax_codec.py_loads(raw)):
                assert _eq(back, obj)


def test_depth_and_length_errors_are_codec_errors(accel):
    deep = b"l\x00\x00\x00\x01" * (codec._MAX_DEPTH + 10) + b"N"
    for loads in (accel.loads, codec.py_loads):
        with pytest.raises(codec.CodecError):
            loads(deep)
    nested = None
    for _ in range(codec._MAX_DEPTH + 10):
        nested = [nested]
    for dumps in (accel.dumps, codec.py_dumps):
        with pytest.raises(codec.CodecError):
            dumps(nested)
    # exactly at the limit both accept, and agree
    ok = None
    for _ in range(codec._MAX_DEPTH):
        ok = [ok]
    assert accel.dumps(ok) == codec.py_dumps(ok)
    with pytest.raises(codec.CodecError):
        codec._pack_u32(2 ** 32)
    # a length past u32 without 4 GiB of payload: an empty array with a
    # dimension of 2**32; and a hostile header's length is a truncation
    with pytest.raises(codec.CodecError):
        accel.loads(b"s\xff\xff\xff\xff")
    for dumps in (accel.dumps, codec.py_dumps, jax_codec.py_dumps):
        with pytest.raises(codec.CodecError if dumps is not jax_codec.py_dumps
                           else jax_codec.CodecError, match="u32"):
            dumps(np.zeros((2 ** 32, 0), np.float32))
    for dumps in (accel.dumps, codec.py_dumps):
        with pytest.raises(codec.CodecError):
            dumps(2 ** 64)
        with pytest.raises(codec.CodecError):
            dumps({"x": object()})
        with pytest.raises(codec.CodecError):
            dumps(np.array([object()], dtype=object))


def test_malformed_frames_are_codec_errors(accel):
    frame = codec.py_dumps({"a": [1, 2.5, "s"], "arr": np.arange(6, dtype=np.float32).reshape(2, 3)})
    for loads in (accel.loads, codec.py_loads):
        for i in range(len(frame)):
            with pytest.raises(codec.CodecError):
                loads(frame[:i])
        with pytest.raises(codec.CodecError):
            loads(frame + b"x")
        with pytest.raises(codec.CodecError):
            loads(b"a\x00\x00\x00\x03<f4\x00\x00\x00\x01\x00\x00\x00\x05\x00\x00\x00\x04abcd")
        with pytest.raises(codec.CodecError):
            loads(b"Z")


_leaf = st.one_of(
    st.none(), st.booleans(), st.integers(-(2 ** 63), 2 ** 63 - 1),
    st.floats(allow_nan=False), st.text(max_size=12), st.binary(max_size=24),
    st.builds(lambda shape, seed, dt: np.random.default_rng(seed).standard_normal(shape).astype(dt),
              st.lists(st.integers(0, 3), max_size=3).map(tuple), st.integers(0, 2 ** 16),
              st.sampled_from([np.float32, np.float64, np.int32, np.int8, np.bool_])),
)
_tree = st.recursive(_leaf, lambda kids: st.one_of(
    st.lists(kids, max_size=4), st.lists(kids, max_size=4).map(tuple),
    st.dictionaries(st.text(max_size=6), kids, max_size=4)), max_leaves=20)


@settings(max_examples=150, deadline=None)
@given(_tree)
def test_round_trip_agrees_with_the_specification(obj):
    acc = codec.get_accel()
    raw = acc.dumps(obj)
    assert raw == codec.py_dumps(obj) == jax_codec.py_dumps(obj)
    assert _eq(acc.loads(raw), obj) and _eq(codec.py_loads(raw), obj)


def test_changed_source_is_rebuilt(tmp_path):
    """The library's name carries the source's hash: an edited source builds
    a new library beside the old one, and each loads."""
    src = tmp_path / "_codec_accel.c"
    src.write_bytes(_codec_build.SRC.read_bytes())
    first = _codec_build.load(src, tmp_path / "build")
    src.write_bytes(_codec_build.SRC.read_bytes() + b"\n/* edited */\n")
    second = _codec_build.load(src, tmp_path / "build")
    built = sorted(p.name for p in (tmp_path / "build").glob("*.so"))
    assert len(built) == 2 and first.__file__ != second.__file__
    assert Path(second.__file__).name == _codec_build.library_path(src, tmp_path / "build").name
    second.init(codec.CodecError, np)
    assert second.dumps([1, "x"]) == codec.py_dumps([1, "x"])


def test_missing_symbol_raises_import_error(tmp_path):
    src = tmp_path / "_codec_accel.c"
    text = _codec_build.SRC.read_text()
    entry = '    {"fill_column", c_fill_column, METH_VARARGS,\n'
    assert entry in text
    # drop the fill_column entry of the method table
    cut = text.index(entry)
    end = text.index("},\n", cut) + 3
    src.write_text(text[:cut] + text[end:])
    with pytest.raises(ImportError, match="fill_column"):
        _codec_build.load(src, tmp_path / "build")


def test_disable_switch_runs_pure_python():
    """HANDYRL_NO_CODEC_ACCEL=1 leaves the pure-Python codec working; the
    decision is made once per process, so it is checked in a child."""
    script = (
        "from handyrl_tpu_torch.runtime import codec, batch\n"
        "assert codec.get_accel() is None and batch._fill_accel() is None\n"
        "b = codec.dumps({'x': [1, 2.5, 'y']})\n"
        "assert b == codec.py_dumps({'x': [1, 2.5, 'y']})\n"
        "assert codec.loads(b) == {'x': [1, 2.5, 'y']}\n"
        "print('fallback-ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "HANDYRL_NO_CODEC_ACCEL": "1", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert "fallback-ok" in out.stdout
