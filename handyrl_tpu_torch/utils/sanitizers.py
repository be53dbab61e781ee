"""Runtime sanitizers: host syncs and run-time builds inside a window.

Counterpart of ``handyrl_tpu/utils/sanitizers.py``.  Two context managers,
cheap enough for tests and the chip smoke to arm around real training
windows:

* ``HostSyncSanitizer`` instruments the port's blocking host transfer
  points (``Tensor.item``, ``.tolist``, ``.cpu``, ``.numpy``,
  ``__array__``, ``__float__``/``__int__``/``__bool__``,
  ``torch.cuda.synchronize`` and ``Event``/``Stream.synchronize``) for the
  window and reports every hit as a named site (file:line:function).  The
  ``batch_pipeline: device`` window (batches sampled and assembled on the
  card, train steps on them) must record none.  Outside the card the same
  calls are counted: they are where the card would wait.
* ``RecompileSentinel`` counts what the port compiles at run time.  The
  port has no JIT: eager PyTorch compiles nothing, and the only run-time
  compile is a build of a ``csrc`` source by ``ops/cuda_build.py``
  (``CudaKernel.build`` when no library of that source exists yet).  The
  JAX contract, zero compiles after the warm-up, is zero builds here.

Both attribute events to their thread and restore every patched entry
point on exit, even when the body raises.
"""

from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Sequence, Tuple

__all__ = ["RecompileSentinel", "HostSyncSanitizer", "SyncEvent", "CompileEvent",
           "DEFAULT_ALLOWED_SITES"]

_TORCH_PATH_MARKERS = ("/torch/", "site-packages/torch")
_SELF_MARKERS = ("utils/sanitizers.py",)


def _attribute_site(skip_markers: Sequence[str] = ()) -> Tuple[str, int, str]:
    """The deepest stack frame that is neither torch nor this module: the
    site to blame.  Falls back to the deepest frame."""
    stack = traceback.extract_stack()
    for frame in reversed(stack):
        fn = frame.filename.replace("\\", "/")
        if any(m in fn for m in _TORCH_PATH_MARKERS + _SELF_MARKERS + tuple(skip_markers)):
            continue
        if fn.endswith(("threading.py", "contextlib.py")):
            continue
        return (fn, frame.lineno or 0, frame.name)
    last = stack[-1]
    return (last.filename, last.lineno or 0, last.name)


def _short(path: str, keep: int = 3) -> str:
    return "/".join(path.replace("\\", "/").split("/")[-keep:])


class _Patches:
    """Attributes replaced for a window and put back exactly: an attribute
    the class only inherited is deleted again, not copied down."""

    def __init__(self):
        self._saved: List[Tuple[Any, str, bool, Any]] = []

    def patch(self, obj: Any, name: str, make: Callable[[Any], Any]) -> None:
        own = name in vars(obj)
        orig = vars(obj)[name] if own else getattr(obj, name)
        self._saved.append((obj, name, own, orig))
        setattr(obj, name, make(getattr(obj, name)))

    def restore(self) -> None:
        while self._saved:
            obj, name, own, orig = self._saved.pop()
            try:
                if own:
                    setattr(obj, name, orig)
                else:
                    delattr(obj, name)
            except Exception:
                pass


# -- recompile sentinel ---------------------------------------------------------


@dataclass
class CompileEvent:
    site: Tuple[str, int, str]
    thread: str
    duration_s: float
    source: str = ""

    def format(self) -> str:
        f, line, func = self.site
        return (f"{self.source} built at {_short(f)}:{line} in {func}() [{self.thread}] "
                f"({self.duration_s:.3f}s)")


class RecompileSentinel:
    """Context manager counting run-time builds of the kernels in a window.

    Wraps ``CudaKernel.build``: a call that compiles (no library of the
    source exists yet) is one event, blamed on its caller; a call that
    finds the library built is none.  Usage::

        with RecompileSentinel() as sentinel:
            ...a warm window of the hot loop...
        sentinel.assert_no_recompiles("device pipeline window")
    """

    def __init__(self) -> None:
        self.events: List[CompileEvent] = []
        self._lock = threading.Lock()
        self._patches = _Patches()

    def _on_build(self, source: str, duration: float) -> None:
        event = CompileEvent(site=_attribute_site(("ops/cuda_build.py",)),
                             thread=threading.current_thread().name,
                             duration_s=float(duration), source=source)
        with self._lock:
            self.events.append(event)

    def __enter__(self) -> "RecompileSentinel":
        from ..ops.cuda_build import CudaKernel

        def make(orig):
            def build(kernel, *args, **kwargs):
                fresh = not kernel.library_path().exists()
                t0 = time.perf_counter()
                out = orig(kernel, *args, **kwargs)
                if fresh:
                    self._on_build(kernel.source.name, time.perf_counter() - t0)
                return out

            return build

        self._patches.patch(CudaKernel, "build", make)
        return self

    def __exit__(self, *exc: Any) -> None:
        self._patches.restore()

    @property
    def count(self) -> int:
        return len(self.events)

    def report(self) -> str:
        if not self.events:
            return "RecompileSentinel: no compilations in window"
        lines = [f"RecompileSentinel: {len(self.events)} compilation(s) in window:"]
        lines += [f"  - {e.format()}" for e in self.events]
        return "\n".join(lines)

    def assert_no_recompiles(self, context: str = "") -> None:
        if self.events:
            prefix = f"[{context}] " if context else ""
            raise AssertionError(prefix + self.report())


# -- host-sync sanitizer ----------------------------------------------------------


# sites where a blocking sync is the documented mechanism, not a leak: (path
# fragment, function name) matched against the immediate caller of the
# instrumented entry point.  The JAX package allows its dispatch lock,
# which holds the device until the outputs are ready on its CPU backend;
# the port's lock (parallel/dispatch.py) covers the enqueue only, so
# nothing there syncs today, and the entry keeps the two lists alike
DEFAULT_ALLOWED_SITES: Tuple[Tuple[str, str], ...] = (
    ("parallel/dispatch.py", "dispatch_serialized"),
)

# (kind, the tensor methods that copy to the host and wait)
_TENSOR_SYNCS = ("item", "tolist", "cpu", "numpy", "__array__", "__float__", "__int__",
                 "__bool__")


@dataclass
class SyncEvent:
    kind: str                       # the entry point: item, tolist, cuda.synchronize, ...
    site: Tuple[str, int, str]
    thread: str
    count: int = 1

    def format(self) -> str:
        f, line, func = self.site
        return f"{self.kind} at {_short(f)}:{line} in {func}() [{self.thread}] x{self.count}"


class HostSyncSanitizer:
    """Context manager counting blocking host syncs by named site.

    For the window it wraps the tensor methods that copy to the host
    (``item``, ``tolist``, ``cpu``, ``numpy``, ``__array__``, ``__float__``,
    ``__int__``, ``__bool__``), ``torch.cuda.synchronize`` and
    ``torch.cuda.Event.synchronize``/``Stream.synchronize``.  A re-entrant
    inner hit (``__array__`` -> ``numpy``) counts once.  Events whose
    immediate caller matches ``allow`` are kept in ``allowed_events``:
    shown by the report, left out of ``assert_clean``.  Usage::

        with HostSyncSanitizer() as sync:
            ...the batch_pipeline: device window...
        sync.assert_clean("device pipeline window")
    """

    def __init__(self, allow: Sequence[Tuple[str, str]] = DEFAULT_ALLOWED_SITES):
        self.allow = tuple(allow)
        self.events: List[SyncEvent] = []
        self.allowed_events: List[SyncEvent] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._patches = _Patches()

    # -- recording -------------------------------------------------------------

    def _record(self, kind: str) -> None:
        stack = traceback.extract_stack()
        # the immediate caller: the frame above the wrapper ([-2])
        caller = stack[-3] if len(stack) >= 3 else stack[0]
        caller_file = caller.filename.replace("\\", "/")
        allowed = any(frag in caller_file and caller.name == func for frag, func in self.allow)
        site = _attribute_site()
        event = SyncEvent(kind=kind, site=site, thread=threading.current_thread().name)
        with self._lock:
            bucket = self.allowed_events if allowed else self.events
            for existing in bucket:
                if existing.kind == kind and existing.site == site:
                    existing.count += 1
                    return
            bucket.append(event)

    def _guarded(self, kind: str) -> Callable[[Any], Any]:
        def make(orig):
            def wrapper(*args: Any, **kwargs: Any):
                if getattr(self._tls, "inside", False):
                    return orig(*args, **kwargs)
                self._tls.inside = True
                try:
                    self._record(kind)
                    return orig(*args, **kwargs)
                finally:
                    self._tls.inside = False

            wrapper.__name__ = getattr(orig, "__name__", kind)
            return wrapper

        return make

    # -- patching ----------------------------------------------------------------

    def __enter__(self) -> "HostSyncSanitizer":
        import torch

        try:
            for name in _TENSOR_SYNCS:
                self._patches.patch(torch.Tensor, name, self._guarded(name))
            self._patches.patch(torch.cuda, "synchronize", self._guarded("cuda.synchronize"))
            for cls in (torch.cuda.Event, torch.cuda.Stream):
                self._patches.patch(cls, "synchronize",
                                    self._guarded(f"{cls.__name__}.synchronize"))
        except BaseException:
            self._patches.restore()
            raise
        return self

    def __exit__(self, *exc: Any) -> None:
        self._patches.restore()

    # -- reporting ---------------------------------------------------------------

    @property
    def count(self) -> int:
        return sum(e.count for e in self.events)

    def report(self) -> str:
        lines: List[str] = []
        if not self.events:
            lines.append("HostSyncSanitizer: no blocking host syncs in window")
        else:
            lines.append(f"HostSyncSanitizer: {self.count} blocking host sync(s) "
                         f"at {len(self.events)} site(s):")
            lines += [f"  - {e.format()}" for e in self.events]
        if self.allowed_events:
            lines.append(f"  (allowed: {sum(e.count for e in self.allowed_events)} "
                         f"at {len(self.allowed_events)} allowlisted site(s))")
        return "\n".join(lines)

    def assert_clean(self, context: str = "") -> None:
        if self.events:
            prefix = f"[{context}] " if context else ""
            raise AssertionError(prefix + self.report())
