"""Twin-less env compiler: pure numpy single-game rules -> a batched torch
device twin.

Counterpart of ``handyrl_tpu/envs/autovec.py``.  A game written once as
pure single-game numpy functions (the ``rules`` namespace below) is lifted
by ``autovectorize`` into the episodic twin contract of
``VectorTicTacToe`` (the one ``runtime/device_rollout.py``'s
``DeviceRollout`` drives), with no hand-written ``vector_*`` module:

1. **numpy rebound to torch**: each rules function is rebuilt over a
   globals dict whose ``numpy`` module aliases point at a torch shim, one
   per device: array constructors (``np.arange``, ``np.ones``,
   ``np.int8(v)``, ...) make tensors on that device, and module-level
   numpy arrays (``WIN_LINES``) are copied there once.  Arrays inside a
   lifted function are ``_Arr`` tensors, which add the numpy methods the
   rules call (``astype``, ``copy``) and refuse every in-place write, as
   JAX's immutable arrays do;
2. **shape and dtype checks at lift time**: every function runs once
   batched on the meta device (no storage, no compute: the stand-in for
   ``jax.eval_shape``).  A rule that cannot be lifted (an in-place write,
   python control flow on an array value, a numpy API with no torch
   counterpart, an unstable shape) fails there as an ``AutovecError``
   naming the function and the rule it broke;
3. **vmap batching and totality**: the single-game functions are batched
   with ``torch.func.vmap``, and ``apply`` is made total as every hand
   twin is: finished lanes pass through unchanged by a per-lane select.

Liftability rules (quoted in every AutovecError):

* functions are pure: no mutation of their inputs, no global state, no
  randomness (``np.random`` is refused);
* arrays are updated out of place (``np.where``, arithmetic; never
  ``arr[i] = v``);
* no python control flow on array values (``if board[x]:`` fails under
  vmap; branch with ``np.where``); control flow on the python-int ``step``
  is fine;
* fixed shapes and dtypes: ``apply`` returns a state dict identical in
  keys, shapes and dtypes to its input;
* ``import numpy as np`` (a module import): from-imported numpy functions
  are not rebound.

The lifted class has ``__autovec__ = True`` and ``verify(n_games, seed,
device)``: random games stepped through the numpy rules and the lift
together, every observable compared per step; the learner runs it at
start under ``autovec_verify_games``.
"""

from __future__ import annotations

import threading
import types
from typing import Any, Dict

import numpy as np
import torch
from torch.func import vmap

from ..utils import resolve_device

__all__ = ["AutovecError", "autovectorize"]

_RULES = (
    "autovec liftability rules: pure functions; out-of-place array "
    "updates only (lifted arrays are immutable); no python control flow on "
    "array values (np.where instead); fixed shapes/dtypes per function; "
    "apply() returns a state tree identical in structure/shape/dtype to "
    "its input; 'import numpy as np' module imports only.  See "
    "docs/league.md §Autovec liftability."
)


class AutovecError(RuntimeError):
    """A rules namespace cannot be lifted (or failed step-parity)."""


# -- numpy dtypes and arrays in torch ------------------------------------------

_DTYPES = {
    "bool_": torch.bool, "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64, "intp": torch.int64,
    "float16": torch.float16, "float32": torch.float32, "single": torch.float32,
    "float64": torch.float64, "double": torch.float64,
}
# JAX's lift (64-bit types off) reads python's int and float as 32-bit
_PY_TYPES = {bool: torch.bool, int: torch.int32, float: torch.float32}


def _torch_dtype(dtype):
    """A dtype argument of the rules (the shim's, python's, numpy's or
    torch's) as a torch dtype; None passes."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, _DType):
        return dtype.torch
    if dtype in _PY_TYPES:
        return _PY_TYPES[dtype]
    try:
        return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype
    except TypeError:
        raise AutovecError(f"dtype {dtype!r} has no torch counterpart.  {_RULES}") from None


def _inplace(name: str) -> bool:
    if name.startswith("__"):
        return name == "__setitem__" or (name.startswith("__i") and name not in (
            "__init__", "__index__", "__int__", "__invert__", "__iter__"))
    return name.endswith("_")


class _Arr(torch.Tensor):
    """A tensor inside a lifted function: numpy's methods where torch's
    differ, and no in-place write (JAX's arrays are immutable, and a write
    into a vmap input would reach the caller's state)."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if _inplace(name) or (kwargs and kwargs.get("out") is not None):
            raise AutovecError(
                f"in-place array update ({name}) is not liftable (lifted arrays are "
                "immutable; use np.where or arithmetic to build the new array)")
        return super().__torch_function__(func, types, args, kwargs)

    def astype(self, dtype):
        return self.to(_torch_dtype(dtype))

    def copy(self):
        return self.clone()


def _arr(x):
    return x.as_subclass(_Arr) if isinstance(x, torch.Tensor) else x


def _plain(x):
    return x.as_subclass(torch.Tensor) if isinstance(x, torch.Tensor) else x


class _DType:
    """``np.int8`` and its kind inside a lifted function: a dtype argument,
    and called, numpy's scalar constructor (or cast)."""

    def __init__(self, name: str, device):
        self.torch = _DTYPES[name]
        self._device = device

    def __call__(self, value=0):
        if isinstance(value, torch.Tensor):
            return _arr(value.to(self.torch))
        return _arr(torch.full((), value, dtype=self.torch, device=self._device))

    def __eq__(self, other):
        return self.torch == _torch_dtype(other)

    def __hash__(self):
        return hash(self.torch)


def _kwargs(kwargs):
    out = {}
    for key, value in kwargs.items():
        key = {"axis": "dim", "keepdims": "keepdim"}.get(key, key)
        out[key] = _torch_dtype(value) if key == "dtype" else value
    return out


class _TorchShim(types.ModuleType):
    """Stands in for the ``numpy`` module inside lifted functions, for one
    device: constructors make tensors there; any other name is torch's
    function of that name (``np.where``, ``np.stack``, ``np.concatenate``,
    ...), with numpy's ``axis``/``keepdims``/``dtype`` keywords translated;
    a name torch lacks, and ``np.random``, fail with the liftability
    rules."""

    def __init__(self, device):
        super().__init__("autovec_torch_shim")
        self._device = device
        self.newaxis = None
        self.pi, self.e, self.inf, self.nan = np.pi, np.e, np.inf, np.nan
        for name in _DTYPES:
            setattr(self, name, _DType(name, device))

    def _new(self, fn, *args, dtype=None, **kwargs):
        return _arr(fn(*args, dtype=_torch_dtype(dtype), device=self._device, **kwargs))

    def arange(self, *args, dtype=None):
        return self._new(torch.arange, *args, dtype=dtype)

    def zeros(self, shape, dtype=float):
        return self._new(torch.zeros, shape, dtype=dtype)

    def ones(self, shape, dtype=float):
        return self._new(torch.ones, shape, dtype=dtype)

    def full(self, shape, fill_value, dtype=None):
        return self._new(torch.full, shape, fill_value, dtype=dtype)

    def asarray(self, value, dtype=None):
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value), device=self._device)
        return _arr(value if dtype is None else value.to(_torch_dtype(dtype)))

    array = asarray

    def __getattr__(self, name: str):
        if name == "random":
            raise AutovecError(
                "np.random is not liftable — randomness must come through "
                "explicit state carried by the rules (or stay out of the "
                f"rules entirely).  {_RULES}"
            )
        fn = getattr(torch, name, None)
        if not callable(fn) or name.startswith("_"):
            raise AutovecError(
                f"np.{name} has no torch equivalent; rewrite the rules "
                f"with liftable ops.  {_RULES}"
            )

        def call(*args, **kwargs):
            return _arr(fn(*args, **_kwargs(kwargs)))

        call.__name__ = name
        setattr(self, name, call)   # found directly from now on
        return call


# -- lifting ---------------------------------------------------------------------


def _rule_functions(rules) -> Dict[str, Any]:
    """The plain functions defined on the rules namespace (staticmethods
    unwrapped), by name."""
    fns: Dict[str, Any] = {}
    for name, attr in vars(rules).items():
        if name.startswith("__"):
            continue
        if isinstance(attr, staticmethod):
            fns[name] = attr.__func__
        elif isinstance(attr, types.FunctionType):
            fns[name] = attr
    return fns


def _lift_namespace(rules, device) -> types.SimpleNamespace:
    """Every rules function rebuilt over a globals dict whose numpy module
    aliases point at the torch shim of ``device`` and whose numpy arrays
    are tensors there.  A call of ``MyRules.helper(...)`` inside a lifted
    body reaches the lifted helper: the namespace binds itself under the
    rules class's name."""
    fns = _rule_functions(rules)
    if not fns:
        raise AutovecError(f"{rules.__name__} defines no functions to lift.  {_RULES}")
    base_globals = next(iter(fns.values())).__globals__
    lifted_globals = dict(base_globals)
    rebound = [k for k, v in base_globals.items() if v is np]
    shim = _TorchShim(device)
    for k in rebound:
        lifted_globals[k] = shim
    if not rebound:
        # rules that never touch numpy are legal, but a module that
        # from-imported numpy functions is the common trap
        for k, v in base_globals.items():
            if getattr(v, "__module__", None) and v.__module__.startswith("numpy"):
                raise AutovecError(
                    f"global {k!r} is a from-imported numpy function; only "
                    f"'import numpy as np' module aliases are rebound.  {_RULES}"
                )
    for k, v in base_globals.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            lifted_globals[k] = _arr(torch.as_tensor(v, device=device))
    ns = types.SimpleNamespace()
    for name, fn in fns.items():
        new = types.FunctionType(fn.__code__, lifted_globals, fn.__name__, fn.__defaults__,
                                 fn.__closure__)
        new.__kwdefaults__ = fn.__kwdefaults__
        setattr(ns, name, new)
    lifted_globals[rules.__name__] = ns
    return ns


def _state_template(rules) -> Dict[str, np.ndarray]:
    try:
        template = rules.init()
    except Exception as exc:
        raise AutovecError(
            f"{rules.__name__}.init() failed under host numpy: "
            f"{type(exc).__name__}: {exc}.  {_RULES}"
        ) from exc
    if not isinstance(template, dict) or not template:
        raise AutovecError(
            f"{rules.__name__}.init() must return a non-empty dict of "
            f"numpy arrays (got {type(template).__name__}).  {_RULES}"
        )
    out = {}
    for k, v in template.items():
        arr = np.asarray(v)
        if arr.dtype == object:
            raise AutovecError(
                f"{rules.__name__}.init()[{k!r}] is not a fixed-dtype array.  {_RULES}")
        out[k] = arr
    return out


def _batched(fn, in_dims):
    """``fn`` over single-game arrays, batched over the lanes (``in_dims``:
    0 for a batched argument, None for the python-int step): ``_Arr``
    inside, plain tensors outside."""
    def single(*args):
        out = fn(*[{k: _arr(v) for k, v in a.items()} if isinstance(a, dict) else _arr(a)
                   for a in args])
        if isinstance(out, dict):
            return {k: _plain(v) for k, v in out.items()}
        return _plain(out)

    return vmap(single, in_dims=in_dims)


def _trace(rules_name: str, fn_name: str, fn, *args):
    """Run ``fn`` batched on meta tensors: where in-place writes,
    value-dependent branches and missing torch APIs show, re-raised as
    AutovecError naming the function.  A write into an input is also
    caught by its version counter."""
    leaves = [v for a in args for v in (a.values() if isinstance(a, dict) else [a])
              if isinstance(v, torch.Tensor)]
    versions = [t._version for t in leaves]
    try:
        out = fn(*args)
    except AutovecError as exc:
        raise AutovecError(f"{rules_name}.{fn_name} is not liftable: {exc}") from exc
    except Exception as exc:
        hint = ""
        if "data-dependent control flow" in str(exc) or "meta tensors" in str(exc):
            hint = " (python control flow on an array value — branch with np.where instead)"
        raise AutovecError(
            f"{rules_name}.{fn_name} is not liftable: {type(exc).__name__}: {exc}{hint}.  "
            f"{_RULES}") from exc
    if [t._version for t in leaves] != versions:
        raise AutovecError(
            f"{rules_name}.{fn_name} is not liftable: it wrote into its input in place "
            f"(lifted arrays are immutable).  {_RULES}")
    return out


def _check_shapes(rules, fns, template) -> None:
    """Every contract function once, batched over two games on the meta
    device; loud diagnostics for breaks of the shape and dtype contract."""
    name = rules.__name__
    state = {k: torch.empty((2,) + v.shape, dtype=torch.as_tensor(v).dtype, device="meta")
             for k, v in template.items()}
    act = torch.empty(2, dtype=torch.int64, device="meta")
    A, P = int(rules.num_actions), int(rules.num_players)

    def per_game(t):
        return tuple(t.shape[1:]), t.dtype

    obs0 = _trace(name, "observation", fns.observation, state, 0)
    obs1 = _trace(name, "observation", fns.observation, state, 1)
    if per_game(obs0) != per_game(obs1):
        raise AutovecError(
            f"{name}.observation changes shape/dtype with step "
            f"({obs0.shape[1:]}/{obs0.dtype} at step 0 vs {obs1.shape[1:]}/"
            f"{obs1.dtype} at step 1); the rollout needs one fixed "
            f"observation spec.  {_RULES}")
    legal = _trace(name, "legal_mask", fns.legal_mask, state)
    if per_game(legal) != ((A,), torch.bool):
        raise AutovecError(
            f"{name}.legal_mask must return a ({A},) bool array "
            f"(num_actions), got {tuple(legal.shape[1:])} {legal.dtype}.  {_RULES}")
    term = _trace(name, "terminal", fns.terminal, state, 0)
    if per_game(term) != ((), torch.bool):
        raise AutovecError(
            f"{name}.terminal must return a scalar bool, got "
            f"{tuple(term.shape[1:])} {term.dtype}.  {_RULES}")
    new = _trace(name, "apply", fns.apply, state, act, 0)
    if not isinstance(new, dict) or set(new) != set(state):
        got = sorted(new) if isinstance(new, dict) else type(new).__name__
        raise AutovecError(
            f"{name}.apply must return the same state keys {sorted(state)}, got {got}.  {_RULES}")
    for k in state:
        if per_game(new[k]) != per_game(state[k]):
            raise AutovecError(
                f"{name}.apply changes state[{k!r}] from {tuple(state[k].shape[1:])} "
                f"{state[k].dtype} to {tuple(new[k].shape[1:])} {new[k].dtype}; state must "
                f"be shape/dtype-stable or the rollout cannot carry it.  {_RULES}")
    outc = _trace(name, "outcome", fns.outcome, state)
    if tuple(outc.shape[1:]) != (P,):
        raise AutovecError(
            f"{name}.outcome must return a ({P},) per-player score array "
            f"(num_players), got {tuple(outc.shape[1:])}.  {_RULES}")


class _Lifted:
    """The batched functions of one rules namespace on one device."""

    def __init__(self, rules, device):
        ns = _lift_namespace(rules, device)
        self.observation = _batched(ns.observation, (0, None))
        self.legal_mask = _batched(ns.legal_mask, (0,))
        self.terminal = _batched(ns.terminal, (0, None))
        self.apply = _batched(ns.apply, (0, 0, None))
        self.outcome = _batched(ns.outcome, (0,))


_LIFT_CACHE: Dict[type, type] = {}


def autovectorize(rules) -> type:
    """Lift a pure-numpy single-game ``rules`` namespace into an episodic
    twin class (the ``VectorTicTacToe`` contract, driven by
    ``runtime/device_rollout.py``); no hand-written twin.

    ``rules`` is a class of pure functions over one game:

        num_actions, max_steps, num_players  (ints)
        init() -> {name: np.ndarray}                      fresh game state
        observation(state, step) -> np.ndarray            turn player's view
        legal_mask(state) -> (num_actions,) bool
        terminal(state, step) -> bool scalar
        apply(state, action, step) -> state               live games only
        outcome(state) -> (num_players,) float scores

    The lift is memoized per rules class and checked at construction; the
    class's ``init(n_games, device)`` puts the games on a device, and every
    other function runs where its state lies.
    """
    cached = _LIFT_CACHE.get(rules)
    if cached is not None:
        return cached
    for attr in ("num_actions", "max_steps", "num_players"):
        if not isinstance(getattr(rules, attr, None), int):
            raise AutovecError(
                f"{getattr(rules, '__name__', rules)!r} needs int attribute {attr!r}.  {_RULES}")
    for fn in ("init", "observation", "legal_mask", "terminal", "apply", "outcome"):
        if not callable(getattr(rules, fn, None)):
            raise AutovecError(f"{rules.__name__} is missing rules function {fn!r}.  {_RULES}")

    template = _state_template(rules)
    spaces: Dict[str, _Lifted] = {}
    lock = threading.Lock()

    def space(device) -> _Lifted:
        with lock:
            out = spaces.get(str(device))
            if out is None:
                out = spaces[str(device)] = _Lifted(rules, device)
        return out

    def lifted(state) -> _Lifted:
        return space(next(iter(state.values())).device)

    _check_shapes(rules, space(torch.device("meta")), template)

    def v_init(n_games: int, device="cpu"):
        device = resolve_device(device)
        return {k: torch.as_tensor(v, device=device).expand((n_games,) + v.shape).contiguous()
                for k, v in template.items()}

    def v_observation(state, step: int):
        return lifted(state).observation(state, step)

    def v_legal_mask(state):
        return lifted(state).legal_mask(state)

    def v_terminal(state, step: int):
        return lifted(state).terminal(state, step)

    def v_apply(state, actions, step: int):
        # totality (the vector_common contract): finished lanes pass
        # through unchanged by a per-lane select; whatever the user's apply
        # computed for them is discarded
        live = ~v_terminal(state, step)
        new = lifted(state).apply(state, actions.long(), step)
        return {k: torch.where(live.view((-1,) + (1,) * (old.dim() - 1)), new[k], old)
                for k, old in state.items()}

    def v_outcome(state):
        return lifted(state).outcome(state).float()

    def verify(cls, n_games: int, seed: int = 0, device=None) -> None:
        """Random-game step-parity: ``n_games`` games stepped through the
        host-numpy rules and the lift on ``device`` (the card unless the
        caller asks for another) together, every observable (observation,
        legal mask, terminal flag, outcome) compared per step.  Raises
        AutovecError on the first divergence."""
        device = resolve_device(device)
        rng = np.random.default_rng(seed)
        hosts = [{k: v.copy() for k, v in _state_template(rules).items()}
                 for _ in range(n_games)]
        state = cls.init(n_games, device)

        def bail(what, step):
            raise AutovecError(
                f"autovec step-parity failed for {rules.__name__}: {what} "
                f"diverged between the numpy rules and the lifted env at step {step}")

        for step in range(int(rules.max_steps)):
            h_term = np.array([bool(rules.terminal(h, step)) for h in hosts])
            if not np.array_equal(h_term, cls.terminal(state, step).cpu().numpy()):
                bail("terminal", step)
            h_legal = np.stack([np.asarray(rules.legal_mask(h)) for h in hosts])
            if not np.array_equal(h_legal, cls.legal_mask(state).cpu().numpy()):
                bail("legal_mask", step)
            h_obs = np.stack([np.asarray(rules.observation(h, step)) for h in hosts])
            if not np.allclose(h_obs, cls.observation(state, step).cpu().numpy(), atol=1e-6):
                bail("observation", step)
            if h_term.all():
                break
            actions = np.zeros(n_games, np.int64)
            for i, h in enumerate(hosts):
                if h_term[i]:
                    continue
                legal = np.flatnonzero(h_legal[i])
                actions[i] = rng.choice(legal) if len(legal) else 0
                hosts[i] = rules.apply(h, int(actions[i]), step)
            state = cls.apply(state, torch.as_tensor(actions, device=device), step)
        h_out = np.stack([np.asarray(rules.outcome(h)) for h in hosts])
        if not np.allclose(h_out.astype(np.float32), cls.outcome(state).cpu().numpy(), atol=1e-6):
            bail("outcome", int(rules.max_steps))

    cls = type(
        f"AutoVec{rules.__name__}",
        (),
        {
            "__doc__": (f"Autovectorized device twin of {rules.__name__} "
                        "(envs/autovec.py): no hand-written vector env."),
            "__autovec__": True,
            "rules": rules,
            "num_actions": int(rules.num_actions),
            "max_steps": int(rules.max_steps),
            "num_players": int(rules.num_players),
            "init": staticmethod(v_init),
            "observation": staticmethod(v_observation),
            "legal_mask": staticmethod(v_legal_mask),
            "terminal": staticmethod(v_terminal),
            "apply": staticmethod(v_apply),
            "outcome": staticmethod(v_outcome),
            "verify": classmethod(verify),
        },
    )
    _LIFT_CACHE[rules] = cls
    return cls
