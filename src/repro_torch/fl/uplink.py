"""Compressed uplinks, a cohort an encode (counterpart of ``repro.fl.uplink``).

The uplink is EchoPFL's thin link, and the paper's communication claim
rests on compressing it. The codecs' arithmetic is in
:mod:`repro_torch.optim.compression` and the cohort encodes in
:mod:`repro_torch.kernels.uplink`; this module wires them into the
simulator's upload path:

* Every client owns an **anchor row** on the codec's own
  :class:`~repro_torch.core.plane.ParameterPlane`, on the run's device: the
  last model both sides agree on. It starts at the initial broadcast
  (:meth:`UplinkCodec.seed`), advances to each upload's reconstruction, and
  jumps to each downlinked model the client installs (:meth:`install`,
  free on the wire: the server knows what it sent).
* An upload compresses ``trained - anchor``: under ``topk`` through
  error-feedback top-k, whose residual is a second row a client; under
  ``int8`` with one scale a chunk. The reconstruction is what the server
  ingests, so its ingest and the broadcast predictor's statistics see what
  crossed the wire.
* A cohort of B uploads (a coalesced window, a synchronous round, or one
  upload per event) is one kernel launch on the card: it reads the anchor
  and residual rows in the plane by id, advances them in place, and returns
  the ``(B, dim)`` reconstruction as a device matrix of its own.
* The wire size of a payload depends on the static config alone, so
  :attr:`UplinkCodec.nbytes` bills every upload without reading the device.

The port takes its configuration by argument (``uplink=`` of the
simulator and the experiment entry points), not from the environment:
``None`` or ``"none"`` (no codec), ``"topk"``, ``"int8"`` or an
:class:`UplinkConfig`. A client evicted for good gives its rows back
(:meth:`UplinkCodec.release_client`). The rows of the seeded clients ride
the server's checkpoints (:meth:`UplinkCodec.state_dict`,
:meth:`UplinkCodec.load_state`, :func:`seed_template`): without them a
restarted run would anchor at zero and ship a whole model's delta.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.common.pytrees import flatten_spec
from repro_torch.core.plane import ParameterPlane
from repro_torch.kernels.uplink import uplink_int8_encode, uplink_topk_encode
from repro_torch.optim.compression import Int8Payload, TopKPayload, payload_bytes, wire_bytes

PyTree = Any

UPLINK_MODES = ("none", "topk", "int8")


@dataclasses.dataclass(frozen=True)
class UplinkConfig:
    """Static uplink-compression config: the mode and the codec's geometry."""

    mode: str = "none"
    k: float = 0.1  # top-k budget: a fraction of the dim in (0, 1), or a count >= 1
    chunk: int = 512  # int8: elements a scale

    def __post_init__(self):
        if self.mode not in UPLINK_MODES:
            raise ValueError(f"uplink mode must be one of {UPLINK_MODES}, got {self.mode!r}")
        if self.k <= 0:
            raise ValueError(f"uplink k must be positive, got {self.k}")
        if self.chunk < 1:
            raise ValueError(f"uplink chunk must be >= 1, got {self.chunk}")

    def resolve_k(self, dim: int) -> int:
        """The keep count a row for a flat dim: a fraction rounds, and both
        forms clamp into [1, dim]."""
        k = self.k * dim if self.k < 1 else self.k
        return max(1, min(dim, int(round(k))))

    def resolve_chunk(self, dim: int) -> int:
        return max(1, min(dim, int(self.chunk)))


def resolve_uplink(spec: Any) -> UplinkConfig:
    """A constructor argument as a config: ``None`` is no codec, a string a
    mode with the default geometry, an :class:`UplinkConfig` itself."""
    if spec is None:
        return UplinkConfig()
    if isinstance(spec, UplinkConfig):
        return spec
    return UplinkConfig(mode=str(spec).strip().lower() or "none")


class UplinkCodec:
    """Each client's uplink state and the cohort encode.

    A dedicated :class:`ParameterPlane` holds each client's anchor row and,
    under ``topk``, its EF residual row. :meth:`encode_vecs` compresses a
    ``(B, dim)`` cohort of trained models against their anchors, advances
    the rows and returns the reconstructions: one launch whatever B
    (:attr:`launches` counts them)."""

    def __init__(self, template: PyTree, client_ids: Sequence[Any], config: UplinkConfig, *,
                 device: torch.device | str):
        if config.mode == "none":
            raise ValueError("UplinkCodec needs mode topk or int8 (none means no codec)")
        self.config = config
        self.mode = config.mode
        self.spec = flatten_spec(template)
        self.dim = self.spec.dim
        self.k = config.resolve_k(self.dim)
        self.chunk = config.resolve_chunk(self.dim)
        self.ids = list(client_ids)
        self.index = {cid: i for i, cid in enumerate(self.ids)}
        K = len(self.ids)
        topk = self.mode == "topk"
        self.plane = ParameterPlane(template, capacity=2 * K if topk else K, device=device)
        self._anchor_row = self.plane.alloc_many(K)
        self._resid_row = self.plane.alloc_many(K) if topk else None
        self._seeded = [False] * K
        self._released = [False] * K  # evicted clients: rows back on the plane's free list
        self._install_memo: tuple[Any, Any] = (None, None)  # (params object, its flat vector)
        self.launches = 0
        # the wire size of one upload, from the static config; equal to what the codecs emit
        self.nbytes = wire_bytes(self.mode, self.dim, k=self.k, chunk=self.chunk)
        assert self.nbytes == payload_bytes(self.payload_template())

    def payload_template(self):
        """A zero payload with the shapes and dtypes every upload ships."""
        if self.mode == "topk":
            return TopKPayload(indices=np.zeros(self.k, np.int32), values=np.zeros(self.k, np.float32),
                               length=self.dim)
        return Int8Payload(q=np.zeros(self.dim, np.int8), scales=np.zeros(-(-self.dim // self.chunk), np.float32),
                           chunk=self.chunk)

    # -------------------------------------------------------------- seeding
    def seed(self, models: dict[Any, PyTree]) -> None:
        """Anchors from a broadcast both sides saw (the run's initial
        models). A client seeded already keeps its rows, so a second run on
        the same codec never clobbers live state. A broadcast hands every
        client one object: it is flattened once."""
        by_obj: dict[int, torch.Tensor] = {}
        rows, vecs = [], []
        for cid, params in models.items():
            i = self.index.get(cid)
            if i is None or self._seeded[i] or self._released[i]:
                continue
            vec = by_obj.get(id(params))
            if vec is None:
                vec = by_obj[id(params)] = self.plane.as_vec(params)
            rows.append(self._anchor_row[i])
            vecs.append(vec)
            self._seeded[i] = True
        if rows:
            self.plane.write_rows(rows, torch.stack(vecs))

    def install(self, cid, params: PyTree) -> None:
        """Move a client's anchor to a model it was just sent, at no wire
        cost, and drop its EF residual: the residual was measured against a
        base the downlink replaced, and adding it again would count the
        same displacement twice. So error feedback spans the uploads
        between two downlinks. Installs of one object in a row (a
        broadcast's fan-out) share one flatten."""
        i = self.index.get(cid)
        if i is None or self._released[i]:
            return
        obj, vec = self._install_memo
        if obj is not params:
            vec = self.plane.as_vec(params)
            self._install_memo = (params, vec)
        self.plane.write(self._anchor_row[i], vec)
        if self._resid_row is not None:
            self.plane.row_view(self._resid_row[i]).zero_()
        self._seeded[i] = True

    def release_client(self, cid) -> None:
        """Give an evicted client's rows (anchor, and residual under top-k)
        back to the plane. Idempotent; a released client is no longer
        seeded or installed, and its encode raises."""
        i = self.index.get(cid)
        if i is None or self._released[i]:
            return
        self.plane.free(self._anchor_row[i])
        if self._resid_row is not None:
            self.plane.free(self._resid_row[i])
        self._released[i] = True
        self._seeded[i] = False

    # ------------------------------------------------------------- encoding
    def encode_vecs(self, cids: Sequence[Any], mat: torch.Tensor) -> torch.Tensor:
        """One launch: compress ``mat[i]`` (client ``cids[i]``'s trained flat
        model) against its anchor, advance the anchor (and residual) rows in
        place, and return the ``(B, dim)`` reconstructions, a device matrix
        of their own. ``cids`` must be distinct (one round in flight a
        client). ``mat`` is only read."""
        idx = [self.index[c] for c in cids]
        if len(set(idx)) != len(idx):
            raise ValueError("encode_vecs: a client appears twice in one cohort")
        for c, i in zip(cids, idx):
            if not self._seeded[i]:
                raise ValueError(f"client {c} has no uplink anchor seeded")
        mat = mat.to(device=self.plane.device, dtype=torch.float32).contiguous()
        anchors = self.plane.index([self._anchor_row[i] for i in idx])
        if self.mode == "topk":
            resid = self.plane.index([self._resid_row[i] for i in idx])
            rec = uplink_topk_encode(self.plane.storage, anchors, resid, mat, self.k)
        else:
            rec = uplink_int8_encode(self.plane.storage, anchors, mat, self.chunk)
        self.launches += 1
        return rec

    def encode_rows(self, cids: Sequence[Any], mat: torch.Tensor) -> tuple[list[PyTree], int]:
        """A cohort's reconstructed trees (views of one device matrix) and
        the wire bytes of each upload."""
        rec = self.encode_vecs(cids, mat)
        return [self.spec.unflatten(v) for v in rec], self.nbytes

    def encode(self, cid, params: PyTree) -> tuple[PyTree, int]:
        """One upload (the per-event loop): the same launch at B = 1."""
        vec = self.plane.as_vec(params)
        return self.spec.unflatten(self.encode_vecs([cid], vec[None, :])[0]), self.nbytes

    # ------------------------------------------------- checkpoint and restart
    def state_dict(self) -> tuple[PyTree, dict]:
        """``(tree, meta)`` of the seeded clients' rows: anchors, and EF
        residuals under ``topk`` (copies of the plane rows); the meta is the
        reference's JSON."""
        seeded = [cid for cid in self.ids if self._seeded[self.index[cid]]]
        tree: dict[str, Any] = {
            "anchors": {str(cid): self.plane.to_pytree(self._anchor_row[self.index[cid]]) for cid in seeded}
        }
        if self.mode == "topk":
            tree["residuals"] = {str(cid): self.plane.to_pytree(self._resid_row[self.index[cid]])
                                 for cid in seeded}
        meta = {"mode": self.mode, "k": self.k, "chunk": self.chunk,
                "clients": sorted(str(cid) for cid in seeded)}
        return tree, meta

    def load_state(self, tree: PyTree, meta: dict, client_id_type=int) -> None:
        """Restore from :meth:`state_dict`'s output (or a checkpoint of it).
        The mode must match; the geometry (``k``, ``chunk``) stays this
        codec's. Every live row is zeroed first, then the restored rows land
        in one write a section; clients this codec does not simulate, or has
        released, are skipped."""
        if meta["mode"] != self.mode:
            raise ValueError(f"uplink codec mode mismatch: checkpoint is {meta['mode']!r}, "
                             f"this run is {self.mode!r}")
        live = [i for i in range(len(self.ids)) if not self._released[i]]
        zeros = torch.zeros((len(live), self.dim), dtype=torch.float32, device=self.plane.device)
        self.plane.write_rows([self._anchor_row[i] for i in live], zeros)
        if self._resid_row is not None:
            self.plane.write_rows([self._resid_row[i] for i in live], zeros)
        self._seeded = [False] * len(self.ids)

        def restore(section: dict, row_of: list[int]) -> list[int]:
            idx, vecs = [], []
            for s, p in section.items():
                i = self.index.get(client_id_type(s))
                if i is None or self._released[i]:  # not simulated, or evicted
                    continue
                idx.append(i)
                vecs.append(self.plane.as_vec(p))
            if idx:
                self.plane.write_rows([row_of[i] for i in idx], torch.stack(vecs))
            return idx

        for i in restore(tree.get("anchors") or {}, self._anchor_row):
            self._seeded[i] = True
        if self.mode == "topk":
            restore(tree.get("residuals") or {}, self._resid_row)


def seed_template(meta: dict, params_template: PyTree) -> PyTree:
    """A tree of :meth:`UplinkCodec.state_dict`'s structure for ``meta``,
    for the checkpointer's restore (every row has the model's structure)."""
    tree: dict[str, Any] = {"anchors": {c: params_template for c in meta["clients"]}}
    if meta["mode"] == "topk":
        tree["residuals"] = {c: params_template for c in meta["clients"]}
    return tree
