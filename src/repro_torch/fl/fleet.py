"""Device-resident client fleet engine: the simulated devices as batched
compute (counterpart of ``repro.fl.fleet``).

Every client's current model is a row of a second
:class:`~repro_torch.core.plane.ParameterPlane`; per-client train/test data
pads into ``(clients, n, ...)`` device tensors with validity masks, built
again before a launch when a client's dataset was replaced (distribution
drift, ``data.synthetic.shift_client``), as the reference's ``_sync_data``
does. Batched calls replace per-client loops:

* :meth:`ClientFleet.train_client` — the async path's single-client local
  round, trained from (and written back to) the client's model row, padded
  like every cohort to a power of two (padded rows train 0 epochs);
  :meth:`ClientFleet.train_rows`, a coalesced window's rounds in one batch;
  :meth:`ClientFleet.train_cohort`, a synchronous round's cohort in one
  batch, from the models the strategy hands out;
* :meth:`ClientFleet.evaluate_fleet` — masked accuracy for the whole fleet;
* :meth:`ClientFleet.feedback_many` — batched (member, center) probes
  emitting the (F_pred, F_true, S_soft) rows the server's chi2 kernels take.

With ``mesh=`` (a :class:`~repro_torch.launch.mesh.PlaneMesh`) the model
plane and the data tensors spread over the mesh's ``plane`` axis: client
i lives on row shard ``i // (K / R)``, and each batched call runs once a
shard that has clients in it, on that shard's clients and device, its
outputs joined in call order on the mesh's first device. A shard's batch
pads to a power of two by the unsharded rule. A fleet whose size the row
shards do not divide runs on one device, as the reference's does.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.common.pytrees import flatten_spec
from repro_torch.core.plane import ParameterPlane
from repro_torch.fl.tasks import MLP_TASK

PyTree = Any


def _pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class ClientFleet:
    """Batched state + launches for a list of :class:`SimClient`s."""

    def __init__(self, clients: Sequence[Any], template: PyTree, *, device: torch.device | str, mesh=None):
        self.clients = list(clients)
        self.ids = [c.client_id for c in self.clients]
        self.index = {cid: i for i, cid in enumerate(self.ids)}
        K = len(self.clients)
        self.device = torch.device(device)
        self.num_classes = self.clients[0].num_classes
        self.task = getattr(self.clients[0], "task", None) or MLP_TASK
        self.spec = flatten_spec(template)
        if mesh is not None and K % mesh.row_shards != 0:
            mesh = None  # the clients do not divide the row shards: one device
        self.mesh = mesh
        self._shard_devices = [self.device] if mesh is None else [row[0] for row in mesh.devices]
        task_dev = getattr(self.task, "device", None)
        if task_dev is not None and any(d != task_dev for d in self._shard_devices):
            raise ValueError(f"the task's frozen weights are on {task_dev}, the fleet's shards on "
                             f"{sorted(set(map(str, self._shard_devices)))}")
        self._per_shard = K // len(self._shard_devices)
        # the model rows only ever hold whole rows: no dim split over a model axis
        self.plane = ParameterPlane(template, capacity=K, device=self.device, mesh=mesh, dim_axis=None)
        self._model_row = [self.plane.alloc() for _ in range(K)]
        self._has_model = [False] * K
        self._build_data()
        # tree -> flat vector memo keyed by object identity (the held
        # reference keeps the id stable): a broadcast hands every member the
        # same center object, so it costs one flatten
        self._flat_cache: dict[int, tuple[Any, torch.Tensor]] = {}

    # ----------------------------------------------------------- data plane
    def _build_data(self) -> None:
        """Pad every client's split into the task's batched tensors (under a
        mesh, each row shard's clients on its device), and keep the datasets
        they were built from."""
        self._data_ref = [c.data for c in self.clients]
        fd = self.task.build_fleet_data(self._data_ref, self.device, self.num_classes)
        if self.mesh is None:
            self._train_data, self._test_data, self.f_true = fd.train, fd.test, fd.f_true
            return
        k = self._per_shard

        def split(t: torch.Tensor) -> list[torch.Tensor]:
            return [t[r * k:(r + 1) * k].to(d, copy=True) for r, d in enumerate(self._shard_devices)]

        self._shard_train = [dict(zip(fd.train, ts)) for ts in zip(*map(split, fd.train.values()))]
        self._shard_test = [dict(zip(fd.test, ts)) for ts in zip(*map(split, fd.test.values()))]
        self._shard_f_true = split(fd.f_true)

    def _sync_data(self) -> None:
        """A replaced ``SimClient.data`` is trained, evaluated and probed on
        from the next launch on: K identity checks a launch, a rebuild only
        when a dataset changed (the reference's ``fleet.py:196``)."""
        for c, ref in zip(self.clients, self._data_ref):
            if c.data is not ref:
                self._build_data()
                return

    def _shards_of(self, idx: np.ndarray):
        """(shard, positions in ``idx``, local client indices) for each row
        shard with clients in ``idx``, shards in order."""
        shard = idx // self._per_shard
        for r in np.unique(shard):
            pos = np.nonzero(shard == r)[0]
            yield int(r), pos, idx[pos] - r * self._per_shard

    def _join(self, parts: list, n: int, like: torch.Tensor) -> torch.Tensor:
        """Shard outputs ``[(positions, tensor)]`` back in call order on the
        first device."""
        out = torch.empty((n,) + tuple(like.shape[1:]), dtype=like.dtype, device=self.device)
        for pos, t in parts:
            out.index_copy_(0, torch.from_numpy(pos).to(self.device), t.to(self.device))
        return out

    # ------------------------------------------------------------ adapters
    def _vec_of(self, params: PyTree) -> torch.Tensor:
        if isinstance(params, torch.Tensor) and params.dim() == 1:
            return params
        key = id(params)
        hit = self._flat_cache.pop(key, None)
        if hit is not None and hit[0] is params:
            self._flat_cache[key] = hit
            return hit[1]
        vec = self.spec.flatten(params).to(self.device)
        if len(self._flat_cache) >= 512:  # evict the least recently used
            self._flat_cache.pop(next(iter(self._flat_cache)))
        self._flat_cache[key] = (params, vec)
        return vec

    # ------------------------------------------------------------- models
    def set_model(self, cid, params: PyTree) -> None:
        i = self.index[cid]
        self.plane.write(self._model_row[i], self._vec_of(params))
        self._has_model[i] = True

    def set_models(self, cids: Sequence[Any], params_list: Sequence[PyTree]) -> None:
        """Install a window's downlinks in one ``write_rows``: a broadcast's
        fan-out hands every member the same center object, which costs one
        flatten. A client listed twice keeps its last model, as sequential
        :meth:`set_model` calls leave it."""
        latest: dict[int, PyTree] = {}
        for cid, p in zip(cids, params_list):
            latest[self.index[cid]] = p
        rows, vecs = [], []
        for i, p in latest.items():
            rows.append(self._model_row[i])
            vecs.append(self._vec_of(p))
            self._has_model[i] = True
        self.plane.write_rows(rows, torch.stack(vecs))

    def model_vec(self, cid) -> torch.Tensor:
        i = self.index[cid]
        if not self._has_model[i]:
            raise ValueError(f"client {cid} has no model set")
        return self.plane.row(self._model_row[i])

    # ------------------------------------------------------------ training
    def _train_specs(self, cids: Sequence[Any]):
        cs = [self.clients[self.index[c]] for c in cids]
        lr = np.asarray([c.lr for c in cs], np.float32)
        epochs = np.asarray([c.local_epochs for c in cs], np.int32)
        head = np.asarray([1.0 if c.partial_finetune else 0.0 for c in cs], np.float32)
        return lr, epochs, head

    def _train(self, idx: np.ndarray, mat: torch.Tensor, lr, epochs, head):
        """Padded batch: returns (S, dim) trained rows + (S,) losses (a batch
        a row shard under a mesh)."""
        self._sync_data()
        if self.mesh is None:
            return self._train_batch(idx, mat, lr, epochs, head, self._train_data)
        vecs, losses = [], []
        for r, pos, local in self._shards_of(idx):
            sel = torch.from_numpy(pos).to(self.device)
            v, loss = self._train_batch(local, mat.index_select(0, sel).to(self._shard_devices[r]), lr[pos],
                                        epochs[pos], head[pos], self._shard_train[r])
            vecs.append((pos, v))
            losses.append((pos, loss))
        return self._join(vecs, len(idx), vecs[0][1]), self._join(losses, len(idx), losses[0][1])

    def _train_batch(self, idx: np.ndarray, mat: torch.Tensor, lr, epochs, head, train_data):
        """One padded batch on ``mat``'s device: (S, dim) rows, (S,) losses."""
        S = len(idx)
        P = _pow2(S)
        if P != S:
            idx = np.concatenate([idx, np.full(P - S, idx[0])])
            mat = torch.cat([mat, mat[:1].expand(P - S, -1)])
            lr = np.concatenate([lr, np.zeros(P - S, np.float32)])
            epochs = np.concatenate([epochs, np.zeros(P - S, np.int32)])  # padded rows train 0 epochs
            head = np.concatenate([head, np.zeros(P - S, np.float32)])
        max_epochs = int(epochs.max()) if len(epochs) else 0
        dev = mat.device
        gather = torch.from_numpy(idx.astype(np.int64)).to(dev)
        data = {k: v.index_select(0, gather) for k, v in train_data.items()}
        params_b = self.spec.unflatten_batched(mat)
        new_b, losses = self.task.fleet_local_train(
            params_b, data, torch.from_numpy(lr).to(dev), torch.from_numpy(epochs).to(dev),
            torch.from_numpy(head).to(dev), max_epochs=max_epochs,
        )
        return self.spec.flatten_batched(new_b)[:S], losses[:S]

    def train_client(self, cid) -> tuple[PyTree, torch.Tensor]:
        """Row-sliced single-client local round (the async event loop):
        trains from this client's model row, writes the new row back, and
        returns the trained params as a tree plus the device-scalar loss."""
        i = self.index[cid]
        mat = self.model_vec(cid)[None, :]
        vecs, losses = self._train(np.asarray([i]), mat, *self._train_specs([cid]))
        vec = vecs[0]
        self.plane.write(self._model_row[i], vec)
        self._has_model[i] = True
        return self.spec.unflatten(vec), losses[0]

    def train_cohort(self, cids: Sequence[Any], params_list: Sequence[PyTree | None]
                     ) -> tuple[list[PyTree], torch.Tensor, torch.Tensor]:
        """A synchronous round's cohort in one padded batch: client
        ``cids[i]`` trains from ``params_list[i]``, or from its own model row
        where that is ``None``. Writes no model row (the round's downlinks
        do). Returns the trained trees, the (S,) losses and the (S, dim)
        device matrix the trees are views of (for the uplink codec)."""
        idx = np.asarray([self.index[c] for c in cids])
        mat = torch.stack([self.model_vec(c) if p is None else self._vec_of(p) for c, p in zip(cids, params_list)])
        vecs, losses = self._train(idx, mat, *self._train_specs(cids))
        return [self.spec.unflatten(v) for v in vecs], losses, vecs

    def train_rows(self, cids: Sequence[Any]) -> tuple[list[PyTree], torch.Tensor, torch.Tensor]:
        """The local rounds of a window's distinct clients in one padded
        batch: each trains from (and writes back) its own model row, the
        rows gathered on the device. Returns the trained trees, the (S,)
        losses and the (S, dim) device matrix the trees are views of."""
        idx = np.asarray([self.index[c] for c in cids])
        for c in cids:
            if not self._has_model[self.index[c]]:
                raise ValueError(f"client {c} has no model set")
        rows = [self._model_row[i] for i in idx]
        vecs, losses = self._train(idx, self.plane.take(rows), *self._train_specs(cids))
        self.plane.write_rows(rows, vecs)
        return [self.spec.unflatten(v) for v in vecs], losses, vecs

    # ---------------------------------------------------------- evaluation
    def evaluate_fleet(self, params_list: Sequence[PyTree | None]) -> np.ndarray:
        """(K,) accuracies in fleet order, one batched call. ``params_list[i]``
        is what client ``i`` evaluates; ``None`` falls back to the client's
        own model row — or 0.0 when no model was ever set."""
        self._sync_data()
        zero = np.zeros(len(self.ids), bool)
        vecs = []
        for i, obj in enumerate(params_list):
            if obj is None:
                if not self._has_model[i]:
                    zero[i] = True
                    vecs.append(torch.zeros(self.spec.dim, device=self.device))
                else:
                    vecs.append(self.plane.row(self._model_row[i]))
            else:
                vecs.append(self._vec_of(obj))
        mat = torch.stack(vecs)
        if self.mesh is None:
            accs = self.task.fleet_evaluate(self.spec.unflatten_batched(mat), self._test_data)
        else:
            k = self._per_shard
            accs = torch.cat([
                self.task.fleet_evaluate(self.spec.unflatten_batched(mat[r * k:(r + 1) * k].to(d)),
                                         self._shard_test[r]).to(self.device)
                for r, d in enumerate(self._shard_devices)
            ])
        accs = accs.cpu().numpy()
        if zero.any():
            accs = np.where(zero, 0.0, accs)
        return accs

    # ------------------------------------------------------------ feedback
    def feedback_many(self, pairs: Sequence[tuple[Any, PyTree]]):
        """Batched (member, center) feedback probes -> device tensors
        (F_pred (M, J), F_true (M, J), S_soft (M, J)), the server's
        ``feedback_batch_fn``."""
        self._sync_data()
        idx = np.asarray([self.index[m] for m, _ in pairs])
        bank_ids: dict[int, int] = {}
        bank_vecs: list[torch.Tensor] = []
        sel = np.empty(len(pairs), np.int64)
        for k, (_, center) in enumerate(pairs):  # distinct centers only
            slot = bank_ids.get(id(center))
            if slot is None:
                slot = bank_ids[id(center)] = len(bank_vecs)
                bank_vecs.append(self._vec_of(center))
            sel[k] = slot
        bank = torch.stack(bank_vecs)
        mat = bank.index_select(0, torch.from_numpy(sel).to(self.device))
        if self.mesh is None:
            return self._feedback_batch(idx, mat, self._train_data, self.f_true)
        outs = [(pos, self._feedback_batch(local, mat.index_select(0, torch.from_numpy(pos).to(self.device))
                                           .to(self._shard_devices[r]), self._shard_train[r],
                                           self._shard_f_true[r]))
                for r, pos, local in self._shards_of(idx)]
        return tuple(self._join([(pos, o[i]) for pos, o in outs], len(idx), outs[0][1][i]) for i in range(3))

    def _feedback_batch(self, idx: np.ndarray, mat: torch.Tensor, train_data, f_true):
        """(F_pred, F_true, S_soft) of one batch on ``mat``'s device."""
        gather = torch.from_numpy(idx.astype(np.int64)).to(mat.device)
        data = {k: v.index_select(0, gather) for k, v in train_data.items()}
        f_pred, s_soft = self.task.fleet_feedback(
            self.spec.unflatten_batched(mat), data, self.num_classes
        )
        return f_pred, f_true.index_select(0, gather), s_soft
