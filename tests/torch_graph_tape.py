"""A CPU stand-in for the CUDA graphs of ``repro_torch.serve`` that
replays what it recorded, as a graph does.

``Tape`` has the backend surface of ``compiled.CudaGraphs`` (``warm``,
``capture``, and the piecewise ``begin`` / ``end`` / ``abandon`` /
``fork`` / ``join`` / ``on_stream``).  A capture records every aten op
the program runs (a ``TorchDispatchMode``, one recording a thread) with
the tensors it read and wrote, and a replay runs those ops again on the
same tensors, in order, writing each op's result into the tensor the
recording made: no Python of the program runs, so a value the program
read on the host is baked into the replay, as it is into a graph.
Reading a tensor's value on the host while recording, or making a
tensor from host data, raises, as a sync or a copy from pageable host
memory does during a capture on the card.  A capture on the card runs
nothing; here the recorded ops do run, so the tensors a recording
writes that it did not make (caches, pools, the buffers of a gather)
are put back as they were when it ends.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

#: ops that read a tensor's value on the host, or make a tensor from
#: host data (on the card a copy from pageable host memory, which a
#: capture refuses)
HOST_READS = frozenset({aten._local_scalar_dense.default, aten.item.default,
                        aten.equal.default, aten.is_nonzero.default,
                        aten.lift_fresh.default})


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _flat(y)]
    return [x]


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _written(func, args, kwargs):
    """The tensors an op writes (its schema's mutable arguments)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        out += [t for t in _flat(v) if isinstance(t, torch.Tensor)]
    return out


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class Recording(TorchDispatchMode):
    """The ops of one capture, and the tensors from outside it that it
    wrote, each saved before its first write."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.made = set()
        self.saved = []
        self._seen = set()
        self.inference = torch.is_inference_mode_enabled()
        self.grad = torch.is_grad_enabled()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in HOST_READS:
            raise RuntimeError(f"{func} reads a tensor's value on the host "
                               "or makes one from host data while a graph "
                               "is captured")
        writes = _written(func, args, kwargs)
        for t in writes:
            if _storage(t) not in self.made and id(t) not in self._seen:
                self._seen.add(id(t))
                self.saved.append((t, t.clone()))
        out = func(*args, **kwargs)
        if not any(r.alias_info is not None for r in func._schema.returns):
            # a fresh output (a view or an in-place op's own argument
            # shares a storage the recording did not make)
            for t in _flat(out):
                if isinstance(t, torch.Tensor):
                    self.made.add(_storage(t))
        self.ops.append((func, args, kwargs, out, bool(writes)))
        return out

    def restore(self) -> None:
        for t, was in reversed(self.saved):
            t.copy_(was)
        self.saved = []

    def replay(self) -> None:
        with torch.inference_mode(self.inference), \
                torch.set_grad_enabled(self.grad):
            for func, args, kwargs, out, writes in self.ops:
                if _is_view(func):
                    continue
                got = func(*args, **kwargs)
                if writes:
                    continue
                for o, g in zip(_flat(out), _flat(got)):
                    if isinstance(o, torch.Tensor):
                        o.copy_(g)


class Tape:
    """``compiled.CudaGraphs``'s place on the CPU (see the module
    docstring).  ``captures`` counts the recordings it closed."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._open = {}
        self.captures = 0

    def fork(self) -> None:
        pass

    def join(self) -> None:
        pass

    def on_stream(self):
        return contextlib.nullcontext()

    def warm(self, fn):
        return fn()

    def begin(self) -> None:
        rec = Recording()
        rec.__enter__()
        self._open[threading.get_ident()] = rec

    def end(self):
        rec = self._open.pop(threading.get_ident())
        rec.__exit__(None, None, None)
        rec.restore()
        self.captures += 1
        return rec.replay

    def abandon(self) -> None:
        if threading.get_ident() in self._open:
            self.end()

    def capture(self, fn):
        self.begin()
        try:
            out = fn()
        except BaseException:
            self.abandon()
            raise
        return self.end(), out


class BrokenTape(Tape):
    """A backend whose every capture fails."""

    def capture(self, fn):
        raise RuntimeError("capture failed")

    def begin(self) -> None:
        raise RuntimeError("capture failed")
