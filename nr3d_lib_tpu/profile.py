"""Hierarchical profiler (host wall-time tree + XLA trace hooks).

Re-design of the reference's host+CUDA-event profiler
(reference: nr3d_lib/profile.py:46-575). Device timing comes from the
XLA profiler (`jax.profiler.trace`) rather than event pairs; the hierarchical
host-side node tree is preserved, with optional device synchronization
(`sync=True` blocks async dispatch at node exit so host wall-time ≈ device
time). `jax.named_scope` annotates the XLA trace with the same node names so
`xprof`/tensorboard traces mirror the host tree.

API parity: `Profiler(warmup, record_frames, record_depth, then)`,
`@profile` decorator / `with profile("name"):` context, `debug_profile`.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, List, Optional

__all__ = ["Profiler", "profile", "debug_profile", "get_default_profiler", "enable_profiling"]


class ProfileNode:
    __slots__ = ("name", "parent", "children", "total", "count", "_t0")

    def __init__(self, name: str, parent: Optional["ProfileNode"] = None):
        self.name = name
        self.parent = parent
        self.children: Dict[str, ProfileNode] = {}
        self.total = 0.0
        self.count = 0
        self._t0 = 0.0

    def child(self, name: str) -> "ProfileNode":
        node = self.children.get(name)
        if node is None:
            node = self.children[name] = ProfileNode(name, self)
        return node


class Profiler:
    """Hierarchical profiler.

    Args:
      warmup: frames to skip before recording (compilation noise).
      record_frames: number of frames to record; after that, ``then`` fires.
      record_depth: max tree depth recorded.
      then: callback ``then(profiler)`` after recording completes.
      sync: call ``jax.effects_barrier()`` (flush async dispatch) at node exit.
    """

    def __init__(self, warmup: int = 0, record_frames: int = -1,
                 record_depth: int = 10, then: Optional[Callable] = None,
                 sync: bool = False, enabled: bool = True):
        self.warmup = warmup
        self.record_frames = record_frames
        self.record_depth = record_depth
        self.then = then
        self.sync = sync
        self.enabled = enabled
        self.root = ProfileNode("<root>")
        self._cur = self.root
        self._depth = 0
        self._frame = 0
        self._done = False

    # ------------------------------------------------------------- frames
    def step_frame(self):
        """Mark a frame boundary (once per training/render iteration)."""
        self._frame += 1
        if (not self._done and self.record_frames > 0
                and self._frame >= self.warmup + self.record_frames):
            self._done = True
            if self.then is not None:
                self.then(self)

    @property
    def recording(self) -> bool:
        return (self.enabled and not self._done and self._frame >= self.warmup
                and self._depth < self.record_depth)

    # -------------------------------------------------------------- scopes
    @contextlib.contextmanager
    def scope(self, name: str):
        if not self.recording:
            yield
            return
        import jax

        node = self._cur.child(name)
        parent = self._cur
        self._cur, self._depth = node, self._depth + 1
        node._t0 = time.perf_counter()
        try:
            with jax.named_scope(name):
                yield
        finally:
            if self.sync:
                jax.effects_barrier()
            node.total += time.perf_counter() - node._t0
            node.count += 1
            self._cur, self._depth = parent, self._depth - 1

    # -------------------------------------------------------------- report
    def report(self, min_frac: float = 0.0) -> str:
        lines: List[str] = [f"{'node':<50} {'total(ms)':>10} {'count':>7} {'avg(ms)':>9} {'%parent':>8}"]

        def visit(node: ProfileNode, depth: int):
            for child in node.children.values():
                frac = child.total / node.total if node.total > 0 else 1.0
                if node is self.root:
                    frac = 1.0
                if frac < min_frac:
                    continue
                avg = child.total / max(child.count, 1)
                lines.append(
                    f"{'  ' * depth + child.name:<50} {child.total * 1e3:>10.3f} "
                    f"{child.count:>7d} {avg * 1e3:>9.3f} {frac * 100:>7.1f}%")
                visit(child, depth + 1)

        visit(self.root, 0)
        return "\n".join(lines)

    def reset(self):
        self.root = ProfileNode("<root>")
        self._cur = self.root
        self._depth = 0
        self._frame = 0
        self._done = False


_default = Profiler(enabled=False)


def get_default_profiler() -> Profiler:
    return _default


def enable_profiling(**kwargs) -> Profiler:
    global _default
    _default = Profiler(enabled=True, **kwargs)
    return _default


def profile(name_or_fn=None):
    """``@profile`` decorator or ``with profile("name"):`` context."""
    if callable(name_or_fn):
        fn = name_or_fn

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _default.scope(fn.__qualname__):
                return fn(*args, **kwargs)

        return wrapped
    name = name_or_fn

    class _Ctx:
        def __enter__(self):
            self._cm = _default.scope(name)
            return self._cm.__enter__()

        def __exit__(self, *exc):
            return self._cm.__exit__(*exc)

        def __call__(self, fn):
            @functools.wraps(fn)
            def wrapped(*args, **kwargs):
                with _default.scope(name):
                    return fn(*args, **kwargs)

            return wrapped

    return _Ctx()


@contextlib.contextmanager
def device_trace(log_dir: str = "/tmp/jax_trace"):
    """Capture an XLA device trace viewable in TensorBoard/xprof.

    The replacement for the reference's CUDA-event device timings
    (reference: profile.py CUDA events): `jax.named_scope` annotations from
    `profile()` nodes appear inside this trace, mirroring the host tree.
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def debug_profile(name: str = "debug"):
    """One-off synchronized timing print (reference: profile.py:564)."""
    import jax

    jax.effects_barrier()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        jax.effects_barrier()
        print(f"[debug_profile] {name}: {(time.perf_counter() - t0) * 1e3:.3f} ms")
