"""The coalesced ingest chain, kernel in ``csrc/ingest_chain.cu``; replaces
``src/repro/kernels/ops.py::ingest_chain`` (a ``lax.scan`` around the TPU
kernel ``l1_distance.py::l1_distance``).

For a segment of S uploads of distinct clients, in event order, each step
scores its upload against the carried center matrix (the blends of every
earlier step included): Eq. 1 distances, the first-index argmin, the
switch veto against the client's previous cluster, a forced (pinned) index
that skips both, the two-op blend of the chosen row, and the predictor's
three statistics ``change = L1(new, old)``, ``gap_before = L1(old,
anchor)`` and ``gap_after = L1(new, anchor)`` against the segment-start
anchors; with ``with_stats`` a fourth, the post-blend center norm ``cnorm =
L1(new, 0)``, which the ingest guard's late check reads. S sequential
per-event steps give the same numbers: on the CPU
bit for bit by construction (:func:`ingest_chain_plain` is that loop), on
the card because the kernel sums in the L1 kernels' order, which the
per-event path's ``l1_vec`` also takes there.

:func:`ingest_chain` is one ctypes call and one cooperative launch per
segment on the card (``ingest_chain.launches`` counts them). Shapes are
exact: the reference pads S and C to powers of two only to bound XLA's
compile cache.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.common.device import to_device
from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import check_f32, use_plain
from repro_torch.kernels.assign_lerp import assign_and_lerp_plain, blend_plain
from repro_torch.kernels.l1 import l1_chunks

MAX_CENTERS = 1024  # kMaxCenters in csrc/ingest_chain.cu


@dataclasses.dataclass
class ChainOut:
    """One segment's results. ``buf`` holds ``blended``, ``dists``,
    ``stats`` and ``cids`` (int32 bits) back to back, so one copy brings
    them all to the host (:meth:`host`); ``carried`` is the center matrix
    after the last step. ``stats`` has a fourth column, ``cnorm``, only
    with ``with_stats``."""

    cids: torch.Tensor  # (S,) int32
    blended: torch.Tensor  # (S, N)
    stats: torch.Tensor  # (S, 3): change, gap_before, gap_after; (S, 4) with cnorm
    dists: torch.Tensor  # (S, C): each step's distances, before its blend
    carried: torch.Tensor  # (C, N)
    buf: torch.Tensor

    @property
    def cnorm(self) -> torch.Tensor | None:
        """(S,) post-blend center norms, or None without ``with_stats``."""
        return self.stats[:, 3] if self.stats.shape[1] == 4 else None

    def host(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(cids, blended, stats)`` as numpy arrays, from one device-to-host copy."""
        S, N = self.blended.shape
        C = self.dists.shape[1]
        K = self.stats.shape[1]
        h = self.buf.cpu().numpy()
        o = S * N + S * C
        return h[o + K * S:].view(np.int32), h[:S * N].reshape(S, N), h[o:o + K * S].reshape(S, K)


def _alloc(S: int, C: int, N: int, carried: torch.Tensor, K: int = 3) -> ChainOut:
    """The output buffer for K statistics a step (3, or 4 with the norm)."""
    buf = torch.empty(S * N + S * C + (K + 1) * S, dtype=torch.float32, device=carried.device)
    o = S * N + S * C
    return ChainOut(
        cids=buf[o + K * S:].view(torch.int32), blended=buf[:S * N].view(S, N),
        stats=buf[o:o + K * S].view(S, K), dists=buf[S * N:o].view(S, C), carried=carried, buf=buf,
    )


def ingest_chain_plain(U, centers, bcast, prev_idx: Sequence[int], forced_idx: Sequence[int], beta: float,
                       switch_margin: float = 0.1, with_stats: bool = False) -> ChainOut:
    """S sequential port steps: ``assign_and_lerp_plain``, the veto in fp32
    numpy (as ``DynamicClustering.assign`` takes it), ``blend_plain`` and
    the plain sum ``torch.sum(torch.abs(a - b))`` (what ``l1_vec`` is on the
    CPU; on the card this version stays plain PyTorch); with ``with_stats``
    also ``torch.sum(torch.abs(c_new))``."""
    S, N = U.shape
    C = centers.shape[0]
    out = _alloc(S, C, N, centers.clone(), 4 if with_stats else 3)
    cmat = out.carried
    omm = np.float32(1.0 - switch_margin)
    for j in range(S):
        dists, _, _ = assign_and_lerp_plain(U[j], cmat, beta)
        d = dists.cpu().numpy()
        amin = int(np.argmin(d))  # the host's rule: first index, a NaN wins
        cid = amin
        if forced_idx[j] >= 0:
            cid = int(forced_idx[j])
        elif prev_idx[j] >= 0 and prev_idx[j] != amin and d[amin] > omm * d[prev_idx[j]]:
            cid = int(prev_idx[j])
        c_old = cmat[cid].clone()
        c_new = blend_plain(c_old, U[j], beta)
        out.stats[j, 0] = torch.sum(torch.abs(c_new - c_old))
        out.stats[j, 1] = torch.sum(torch.abs(c_old - bcast[cid]))
        out.stats[j, 2] = torch.sum(torch.abs(c_new - bcast[cid]))
        if with_stats:
            out.stats[j, 3] = torch.sum(torch.abs(c_new))
        out.dists[j] = dists
        out.cids[j] = cid
        out.blended[j] = c_new
        cmat[cid] = c_new
    return out


def ingest_chain(U: torch.Tensor, centers: torch.Tensor, bcast: torch.Tensor, prev_idx: Sequence[int],
                 forced_idx: Sequence[int], *, beta: float, switch_margin: float = 0.1,
                 with_stats: bool = False) -> ChainOut:
    """U (S, N) uploads, centers and bcast (C, N) the segment-start centers
    and anchors, ``prev_idx``/``forced_idx`` (S,) ints (-1: none) -> the
    segment's :class:`ChainOut`. ``centers`` is not written: the chain
    returns the carried matrix in a buffer of its own. ``with_stats`` adds
    each step's post-blend center norm as a fourth statistic, in the same
    launch and buffer; without it the launch, its outputs and the buffer
    are those of a chain that has no norm."""
    check_f32("ingest_chain", ("U", U, 2), ("centers", centers, 2), ("bcast", bcast, 2))
    S, N = U.shape
    C = centers.shape[0]
    if centers.shape != (C, N) or bcast.shape != (C, N) or S == 0 or C == 0:
        raise ValueError(f"ingest_chain: bad shapes U {tuple(U.shape)}, centers {tuple(centers.shape)}, "
                         f"bcast {tuple(bcast.shape)}")
    if len(prev_idx) != S or len(forced_idx) != S:
        raise ValueError("ingest_chain: prev_idx and forced_idx need one entry per upload")
    if any(not -1 <= int(i) < C for i in (*prev_idx, *forced_idx)):
        raise ValueError(f"ingest_chain: an index outside [-1, {C})")
    if use_plain("ingest_chain", U, centers, bcast):
        return ingest_chain_plain(U, centers, bcast, prev_idx, forced_idx, beta, switch_margin, with_stats)
    if N == 0 or C > MAX_CENTERS:
        raise ValueError(f"ingest_chain kernel: needs N >= 1 and C <= {MAX_CENTERS}, got N {N}, C {C}")
    dev = U.device
    K = 4 if with_stats else 3
    out = _alloc(S, C, N, torch.empty((C, N), dtype=torch.float32, device=dev), K)  # the kernel writes every element
    chunks = l1_chunks(N)
    scratch = torch.empty(2 * chunks * C + S * chunks * K, dtype=torch.float32, device=dev)
    idx = to_device(np.asarray([*prev_idx, *forced_idx], np.int32), dev)
    rc = _build.library().repro_ingest_chain(
        U.data_ptr(), centers.data_ptr(), bcast.data_ptr(), idx.data_ptr(), S, C, N, chunks, float(beta),
        float(switch_margin), scratch.data_ptr(), scratch.data_ptr() + 4 * 2 * chunks * C, out.dists.data_ptr(),
        out.cids.data_ptr(), out.stats.data_ptr(), out.blended.data_ptr(), out.carried.data_ptr(), K,
        dev.index or 0, _build.stream(U),
    )
    _build.check(rc, "ingest_chain")
    ingest_chain.launches += 1
    return out


ingest_chain.launches = 0


def chain_plan(C: int, N: int, device: torch.device | str = "cuda", with_stats: bool = False) -> dict:
    """The launch :func:`ingest_chain` makes on the card for C centers of
    width N: ``blocks`` (one owner a work item of a 4096-element chunk and
    four rows, where they fit at once), ``smem`` (dynamic shared memory
    bytes a block) and ``on_chip`` (the carried rows held in shared memory,
    or else in the output matrix)."""
    dev = torch.device(device)
    plan = np.zeros(3, np.int64)
    rc = _build.library().repro_ingest_chain_plan(C, N, 4 if with_stats else 3, dev.index or 0, plan.ctypes.data)
    _build.check(rc, "ingest_chain plan")
    return {"blocks": int(plan[0]), "smem": int(plan[1]), "on_chip": bool(plan[2])}
