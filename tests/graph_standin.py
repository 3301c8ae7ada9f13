"""A stand-in for a CUDA graph on the CPU, for the tests of the port's
kept graphs (`simulator._GRAPHS`, `lm._STEP_GRAPHS`).

A CUDA graph records the kernels of a piece of work over fixed buffers
and replays them on whatever those buffers hold. Here, while
`fake_capture` stands in for `torch.cuda.graph`, every ATen op is run and
written down with its arguments, and each buffer that existed before and
was written is put back afterwards (a capture runs nothing);
`FakeGraph.replay()` reruns the ops in order on the same tensors, writing
each op's fresh outputs into the recorded ones, as a graph's kernels
write into its pool. An op that read a value on the host while recording
replays with that value, as a graph would.

With `weak=True` the stand-in holds, as a graph does, none of the
tensors made before the capture: it keeps weak references to them, and
an op's views and in-place results are this replay's, so that those
tensors and their memory go when their owners let go of them (a replay
after that raises, where a graph would read freed memory).
"""
import contextlib
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode


def storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _leaves(x) -> list:
    return [t for t in pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]


class _Out:
    """An argument that an earlier recorded op returned: `op`'s `j`th
    output leaf."""

    def __init__(self, op: int, j: int):
        self.op, self.j = op, j


class _Ext:
    """An argument made before the capture, held weakly."""

    def __init__(self, t: torch.Tensor):
        self.ref = weakref.ref(t)


class _Recorder(TorchDispatchMode):
    """Runs and writes down every op; keeps, before its first write, a
    copy of each region an op writes into. With `weak`, each tensor
    argument is written down as an `_Out` or an `_Ext`."""

    def __init__(self, weak: bool = False):
        super().__init__()
        self.ops, self.saved, self._seen = [], [], set()
        self.weak, self._made = weak, {}    # id -> (tensor, op, leaf)

    def _encode(self, x):
        if not isinstance(x, torch.Tensor):
            return x
        made = self._made.get(id(x))
        return _Out(*made[1:]) if made else _Ext(x)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            v = args[i] if i < len(args) else kwargs.get(a.name)
            for t in _leaves(v):
                k = (storage(t), t.storage_offset(), tuple(t.shape),
                     t.stride())
                if k not in self._seen:
                    self._seen.add(k)
                    self.saved.append((t, t.clone()))
        out = func(*args, **kwargs)
        ins = {storage(t) for t in _leaves((args, kwargs))}
        flat = pytree.tree_leaves(out)
        fresh = [(j, o) for j, o in enumerate(flat)
                 if isinstance(o, torch.Tensor) and storage(o) not in ins]
        if self.weak:
            args, kwargs = pytree.tree_map(self._encode, (args, kwargs))
            for j, o in enumerate(flat):
                if isinstance(o, torch.Tensor):
                    self._made[id(o)] = (o, len(self.ops), j)
        self.ops.append((func, args, kwargs, fresh))
        return out


class FakeGraph:
    """Stands in for `torch.cuda.CUDAGraph`: replays the recorded ops."""

    ops = None

    def replay(self):
        outs = []

        def decode(x):
            if isinstance(x, _Out):
                return outs[x.op][x.j]
            if isinstance(x, _Ext):
                t = x.ref()
                if t is None:
                    raise RuntimeError("replay over a freed tensor")
                return t
            return x

        for func, args, kwargs, fresh in self.ops:
            args, kwargs = pytree.tree_map(decode, (args, kwargs))
            flat = pytree.tree_leaves(func(*args, **kwargs))
            for j, o in fresh:
                o.copy_(flat[j])
                flat[j] = o
            outs.append(flat)


RECORDING = []     # non-empty while a stand-in graph records


@contextlib.contextmanager
def fake_capture(graph, pool=None, stream=None, capture_error_mode=None,
                 weak: bool = False):
    rec = _Recorder(weak)
    RECORDING.append(graph)
    try:
        with rec:
            yield
        graph.ops = rec.ops
    finally:
        RECORDING.pop()
        for t, saved in reversed(rec.saved):
            t.copy_(saved)
        rec.saved, rec._made = [], {}
