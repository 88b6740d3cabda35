"""Cost model of a traced step (counterpart of ``repro.launch.hlo_cost``).

The reference lowers a step to XLA, compiles it and walks the optimized
HLO text. The port has no HLO: :class:`CostMode` is a
``TorchDispatchMode`` that sees every aten op a step runs, eagerly, on
``meta`` tensors (shapes and dtypes only: the kernel wrappers take their
plain versions there, ``kernels._dispatch.use_plain``), and counts each by
``hlo_cost.py``'s rules:

* FLOPs: a matrix product (``mm``, ``bmm``, ``addmm``, ``baddbmm``) counts
  ``2 * |result| * K``, K its contracted extent (``dot_flops`` keeps these
  apart); an elementwise op (the ops PyTorch tags ``pointwise``, and dtype
  conversions, the HLO's ``convert``) counts ``|result|``; everything else
  (reductions, softmax, gathers, copies) 0.
* Bytes: each op's result plus its operands. Views, ``empty`` and
  metadata ops move nothing. Eager execution has no fusion, so an
  intermediate that XLA would keep inside a fusion is billed here each
  time it is written and read: bytes are an unfused upper bound, not held
  to XLA's fused count.
* Tensors whose two trailing dims are one of ``skip_trailing`` (the
  attention's ``(S, S)`` scores, masks and probabilities of the plain
  attention) are left out of the bytes, as ``skip_trailing`` is
  (``hlo_cost.py:85-92``); their bytes are tallied in ``skipped_bytes`` and
  the caller adds the flash kernels' analytic traffic instead.
* Collectives: the result bytes of the port's join points, bucketed under
  the reference's names (``models.dist.note_collective``, called by
  ``models.dist.join_sum`` (``all-reduce``), ``join_cat`` (``all-gather``)
  and the joins of ``launch.sharded`` and ``models.steps``), and billed in
  bytes as result plus operands, as ``hlo_cost`` bills a collective. The
  arithmetic inside a join (the partial sums' adds) is the collective's
  own and is not counted as compute.

Per device. One process drives every shard of a model mesh, so each op
belongs to the (batch shard, model rank) that issues it. The shard loops
mark their inputs (``models.dist.place``: a batch shard's rows, a rank's
weight parts); every op's result carries the place of its operands (a
batch shard and rank both named where they agree, ``None`` for "every"
where they differ or are unnamed), and an op counts on every device its
place covers: a rank's work on that device, work replicated over the
ranks (granite's heads that the model axis does not divide, PERF.md §6)
on each of them. :meth:`CostMode.per_device` sums each device's share and
reports the largest, as SPMD's per-device program does.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models import dist

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

aten = torch.ops.aten
_DOTS = {aten.mm.default, aten.bmm.default, aten.addmm.default, aten.baddbmm.default}
_NO_BYTES = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default, aten.detach.default,
             aten.lift_fresh.default, aten._local_scalar_dense.default}
_CONVERT = {aten._to_copy.default}


def _place(t) -> tuple | None:
    return getattr(t, "_cost_place", None)


def _merge(places) -> tuple:
    """The place of an op's result: in each coordinate, the one value its
    operands name (an operand that names none is everyone's, a replicated
    weight), or ``None`` (every) where none names one or two name different
    ones (a join's result, which every device of the axis holds)."""
    out = []
    for axis in (0, 1):
        named = {p[axis] for p in places if p is not None and p[axis] is not None}
        out.append(named.pop() if len(named) == 1 else None)
    return tuple(out)


def _tensors(args) -> list:
    """The tensors among an op's arguments or results (one level of lists,
    as aten ops take them)."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _mark(t, place: tuple) -> None:
    if isinstance(t, torch.Tensor) and place != (None, None):
        t._cost_place = place


class CostMode(TorchDispatchMode):
    """Counts the FLOPs, bytes and collective bytes of the ops run under
    it, by place. ``skip_trailing``: ``(dim -2, dim -1)`` pairs whose
    tensors are left out of the bytes."""

    def __init__(self, skip_trailing: frozenset = frozenset()):
        super().__init__()
        self.skip_trailing = frozenset(skip_trailing)
        self.flops: dict = defaultdict(float)
        self.dot_flops: dict = defaultdict(float)
        self.bytes: dict = defaultdict(float)
        self.collectives: dict = defaultdict(lambda: defaultdict(float))
        self.collective_count: dict = defaultdict(float)
        self.skipped_bytes = 0.0
        self._quiet = 0

    # ------------------------------------------------------------- bytes
    def _nbytes(self, t: torch.Tensor) -> float:
        nb = float(t.numel() * t.element_size())
        if t.dim() >= 2 and (t.shape[-2], t.shape[-1]) in self.skip_trailing:
            self.skipped_bytes += nb
            return 0.0
        return nb

    def _tensors_bytes(self, tensors) -> float:
        return sum(self._nbytes(t) for t in tensors)

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + (_tensors(tuple(kwargs.values())) if kwargs else [])
        place = _merge([_place(t) for t in ins])
        outs = _tensors(out if isinstance(out, (tuple, list)) else (out,))
        for t in outs:
            _mark(t, place)
        if self._quiet or func.is_view or func in _NO_BYTES:
            return out
        elems = float(sum(t.numel() for t in outs))
        if func in _DOTS:
            a = args[1] if func in (aten.addmm.default, aten.baddbmm.default) else args[0]
            f = 2.0 * elems * a.shape[-1]
            self.dot_flops[place] += f
            self.flops[place] += f + (elems if func in (aten.addmm.default, aten.baddbmm.default) else 0.0)
        elif torch.Tag.pointwise in func.tags or func in _CONVERT:
            self.flops[place] += elems
        self.bytes[place] += self._tensors_bytes(outs) + self._tensors_bytes(ins)
        return out

    # -------------------------------------------------------- collectives
    @contextlib.contextmanager
    def quiet(self):
        """Ops inside are a collective's own: their results are marked but
        not counted."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def collective(self, kind: str, result: torch.Tensor, operands) -> None:
        place = _place(result) or (None, None)
        nb = float(result.numel() * result.element_size())
        self.collectives[place][kind] += nb
        self.collective_count[place] += 1
        self.bytes[place] += nb + sum(float(t.numel() * t.element_size()) for t in operands)

    # -------------------------------------------------------- per device
    def per_device(self, batch_shards: int = 1, ranks: int = 1) -> dict:
        """The counts of the device with the most FLOPs (ties: the first in
        shard-major order): ``flops``, ``dot_flops``, ``bytes``,
        ``collectives`` (kind -> bytes), ``collective_count``."""
        best = None
        for b in range(batch_shards):
            for m in range(ranks):
                def on(p):
                    return (p[0] is None or p[0] == b) and (p[1] is None or p[1] == m)

                coll = {k: 0.0 for k in COLLECTIVES}
                for p, d in self.collectives.items():
                    if on(p):
                        for k, v in d.items():
                            coll[k] += v
                rec = {
                    "flops": sum(v for p, v in self.flops.items() if on(p)),
                    "dot_flops": sum(v for p, v in self.dot_flops.items() if on(p)),
                    "bytes": sum(v for p, v in self.bytes.items() if on(p)),
                    "collectives": coll,
                    "collective_count": sum(v for p, v in self.collective_count.items() if on(p)),
                    "device": (b, m),
                }
                if best is None or rec["flops"] > best["flops"]:
                    best = rec
        return best

    def __enter__(self):
        self._prev, dist._COST = dist._COST, self
        return super().__enter__()

    def __exit__(self, *exc):
        dist._COST = self._prev
        return super().__exit__(*exc)
