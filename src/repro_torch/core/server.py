"""The EchoPFL server (counterpart of ``repro.core.server``).

Per arriving update:
  1. assign/confirm cluster (on-arrival L1 clustering, Eq. 1 — the fused
     ``assign_and_lerp`` kernel),
  2. record staleness (never decay/drop),
  3. aggregate into the cluster branch (CI push),
  4. update the cluster's Top-K change records and fine-tune the predictor
     on the realized ground truth (Eq. 4),
  5. unicast the fresh center to the uploader,
  6. RNN broadcast decision: maybe broadcast to the other members,
  7. every ``refine_every`` uploads: feedback-aware refinement — chi2
     feedback for every member (segmented kernel), reassignment and dissolve
     probes (chi2 kernel), expansion, and merging by Algorithm 1 (pairwise
     L1 + merge-attention kernels).

:meth:`EchoPFLServer.handle_uploads` ingests a coalesced window: segments
of consecutive distinct clients go through one ``ingest_chain`` launch
each (steps 1 and 3 and the predictor's statistics), the host replays the
bookkeeping, and the predictor's learn/decide work of each refinement
sub-window runs as one ``predictor_chain`` per touched cluster with one
decision sync. The result is that of sequential ``handle_upload`` calls.

With an ingest guard attached (:meth:`EchoPFLServer.attach_guard`) every
blend is followed by the guard's check of the post-blend center L1 norm:
per event a host sum of the center row, on the coalesced path the chain
kernel's fourth statistic. A failed check rolls the center back to its
newest finite snapshot and re-broadcasts it. :meth:`EchoPFLServer.evict_clients`
retires clients that went dark for good.

``plane_backend="pytree"`` keeps the centers, anchors and last uploads as
parameter trees (:mod:`repro_torch.core.clustering`'s tree mode, behind
the same interface), and the coalesced loop takes the per-upload path, as
the reference's does. ``stats()["plane_rows"]`` is then 0.

``plane_mesh=`` (a :class:`~repro_torch.launch.mesh.PlaneMesh`) shards the
plane's rows over the mesh, and the batched launches of at least
``mesh_min_rows`` rows go a launch a shard: the assign, the segmented
feedback, the reassignment and dissolve probes and the dissolve's L1
sweep. The coalesced chain stays on the first device (its centers are
gathered there, as the reference's are), and :meth:`state_dict` writes
whole rows, so a checkpoint does not depend on the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.common.device import on_device, resolve_device
from repro_torch.core.broadcast import (
    BroadcastPredictor,
    build_seq,
    predictor_chain,
    predictor_for_expansion,
    predictor_for_merge,
    pretrain_rnn,
)
from repro_torch.core.clustering import DynamicClustering
from repro_torch.core.staleness import StalenessTracker
from repro_torch.core.versioning import ModelRepo
from repro_torch.kernels import ops as K
from repro_torch.kernels.chi2 import segmented_numpy

PyTree = Any


@dataclasses.dataclass
class _PredictorPlan:
    """Resolved predictor work for one refinement sub-window: per-step
    broadcast outcomes and the chain's final RNN weights, written back at
    the sub-window's end (before any refine can inherit them)."""

    wants: dict  # step index -> planned decide() outcome
    new_params: dict  # cid -> the chain's final RNN params (device)


@dataclasses.dataclass
class Downlink:
    client_id: Any
    params: PyTree
    version: int
    cluster_id: int
    reason: str  # "unicast" | "broadcast" | "local" (Standalone)


class EchoPFLServer:
    name = "echopfl"
    is_synchronous = False

    def __init__(
        self,
        init_params: PyTree,
        *,
        num_initial_clusters: int = 2,
        mix_rate: float = 0.25,
        hm: float = 2.0,
        top_k: int = 10,
        refine_every: int = 20,
        feedback_fn: Callable[[Any, PyTree], tuple[np.ndarray, np.ndarray, np.ndarray]] | None = None,
        local_train_fn: Callable[[PyTree], PyTree] | None = None,
        rnn_params: dict | None = None,
        enable_clustering: bool = True,
        enable_broadcast: bool = True,
        plane_backend: str = "plane",
        plane_mesh=None,
        mesh_min_rows: int = 128,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.init_params = init_params
        self.clustering = DynamicClustering(
            num_initial_clusters, mix_rate=mix_rate, hm=hm, backend=plane_backend, device=self.device,
            mesh=plane_mesh, mesh_min_rows=mesh_min_rows,
        )
        self.repo = ModelRepo()
        self.staleness = StalenessTracker()
        self.top_k = top_k
        self.refine_every = refine_every
        self.feedback_fn = feedback_fn
        # optional batched probe: [(member, center), ...] -> stacked
        # (F_pred, F_true, S_soft); the simulator's fleet installs one
        self.feedback_batch_fn: Callable[[list], tuple] | None = None
        # the simulator's uplink codec (anchors and EF residuals), when the
        # run compresses; its rows ride state_dict. A load_state that ran
        # before the codec existed keeps the codec's section here until
        # attach_uplink_codec replays it
        self.uplink_codec = None
        self._pending_uplink_state: tuple | None = None
        # the simulator's ingest guard; None keeps every guard hook off: the
        # chain runs without its norm statistic and no snapshot ring exists
        self.guard = None
        self.local_train_fn = local_train_fn
        self.enable_clustering = enable_clustering
        self.enable_broadcast = enable_broadcast
        self._uploads = 0
        self._decisions = 0
        self._rnn_broadcasts = 0
        self._refine_round = 0
        self.last_cluster_feedback_mean: dict[int, float] = {}
        self._rng = np.random.default_rng(seed)
        if not enable_broadcast:
            self._rnn_init = None
        elif rnn_params is not None:
            self._rnn_init = {k: torch.tensor(np.asarray(v), dtype=torch.float32).to(self.device)
                              for k, v in rnn_params.items()}
        else:
            self._rnn_init = pretrain_rnn(seed, device=self.device)
        self.predictors: dict[int, BroadcastPredictor] = {}
        self.client_versions: dict[Any, tuple[int, int]] = {}
        self.events: list[dict] = []

    # ------------------------------------------------------------ protocol
    def initial_models(self, client_ids: list) -> dict[Any, PyTree]:
        return {cid: self.init_params for cid in client_ids}

    def model_for(self, client_id) -> PyTree:
        cid = self.clustering.assignment.get(client_id)
        if cid is None:
            return self.init_params
        return self.clustering.clusters[cid].center

    def attach_uplink_codec(self, codec) -> None:
        """Adopt the simulator's uplink codec: its anchor and residual rows
        ride :meth:`state_dict` and :meth:`load_state`. A restore that ran
        before the codec existed stashed the codec's section; it is replayed
        into the codec here."""
        self.uplink_codec = codec
        if codec is not None and self._pending_uplink_state is not None:
            codec.load_state(*self._pending_uplink_state)
            self._pending_uplink_state = None

    def attach_guard(self, guard) -> None:
        """Adopt the simulator's :class:`~repro_torch.fl.guard.IngestGuard`:
        the post-blend center check runs after every blend, and every
        cluster, present and future, carries a snapshot ring for rollback."""
        self.guard = guard
        if guard is None:
            return
        self.clustering.snapshot_ring = guard.cfg.snapshot_ring
        for c in self.clustering.clusters.values():
            c.ensure_snapshot_ring(guard.cfg.snapshot_ring)

    def _predictor(self, cluster_id: int) -> BroadcastPredictor:
        if cluster_id not in self.predictors:
            size = self.clustering.clusters[cluster_id].size
            self.predictors[cluster_id] = BroadcastPredictor(
                params=self._rnn_init, k=max(self.top_k, size)
            )
        return self.predictors[cluster_id]

    def handle_upload(self, client_id, params: PyTree, base_version: int, n_samples: int,
                      t: float) -> list[Downlink]:
        self._uploads += 1
        out: list[Downlink] = []

        # 1. cluster assignment (or the single global "cluster" in ablation)
        if self.enable_clustering:
            cid, _created = self.clustering.assign(client_id, params)
        else:
            if not self.clustering.clusters:
                self.clustering._new_cluster(self.init_params)
            cid = 0
            self.clustering._move(client_id, 0)
        cl = self.clustering
        cluster = cl.clusters[cid]
        cl.store_upload(client_id, params)
        try:
            branch = self.repo.branch(f"cluster/{cid}")
        except KeyError:
            branch = self.repo.branch(f"cluster/{cid}", cluster.head)

        # 2. staleness bookkeeping (all updates included, none dropped)
        staleness = self._staleness(client_id, cid, cluster)

        # 3. aggregate = CI push into the branch
        pred = self._predictor(cid) if self.enable_broadcast else None
        if pred is not None:  # the pre-update center only feeds the predictor
            prev_center = cluster.head

        def merge_fn(head):
            cl.aggregate(cid, params)
            return cl.clusters[cid].head
        branch.push(client_id, merge_fn, f"upload from {client_id} (staleness {staleness})")

        # 3b. late poison detection (guard only): a non-finite or blown-out
        # post-blend center norm vetoes the blend; the center rolls back and
        # is re-broadcast, and the corrupt blend never feeds the predictor
        if self.guard is not None and not self.guard.center_ok(cid, self._center_norm(cluster)):
            out.extend(self._rollback_center(cluster, branch, client_id))
            if self._uploads % self.refine_every == 0:
                out.extend(self._refine())
            return out

        # 4. Top-K change record + online fine-tune on the ground truth (Eq. 4),
        # and the kind of step 6's decision, taken once the record is in: the
        # fine-tune and an RNN decision are one launch (``pred.step``)
        if pred is not None:
            change = cl.l1(cluster.head, prev_center)
            gap_before = cl.l1(prev_center, cluster.anchor)
            label = 1 if change > gap_before else 0
            pre = build_seq(pred.records, pred.k) if pred.records else None
            pred.observe(change)
            kind = pred.decision_kind() if cluster.size > 1 else None
            want = pred.step(None if pre is None else label, pre, kind == "rnn")

        # 5. unicast fresh center to the uploader
        out.append(Downlink(client_id, cluster.center, cluster.version, cid, "unicast"))
        self.client_versions[client_id] = (cid, cluster.version)

        # 6. on-demand broadcast to the rest of the cluster
        if pred is not None and cluster.size > 1:
            gap = cl.l1(cluster.head, cluster.anchor)
            self._decisions += 1
            if pred.conclude(kind, gap, want):
                self._rnn_broadcasts += 1
                out.extend(self._broadcast(cluster, exclude={client_id}))

        # 7. periodic refinement
        if self._uploads % self.refine_every == 0:
            out.extend(self._refine())
        return out

    def _staleness(self, client_id, cid: int, cluster) -> int:
        """Record and return the upload's staleness (never decayed or dropped)."""
        base_cluster, base_ver = self.client_versions.get(client_id, (cid, 0))
        if base_cluster == cid:
            staleness = max(0, cluster.version - base_ver)
        elif base_cluster in self.clustering.clusters:
            # reassigned client: measured against the branch it trained from
            staleness = max(0, self.clustering.clusters[base_cluster].version - base_ver)
        else:
            # base branch merged away; the merge broadcast refreshed members
            staleness = max(0, cluster.version - cluster.last_broadcast_version)
        self.staleness.record(staleness)
        return staleness

    # ------------------------------------------------------- batched ingest
    def handle_uploads(self, batch: list[tuple]) -> list[list[Downlink]]:
        """Batched ingest of a coalesced window: ``batch`` holds
        ``handle_upload`` argument tuples ``(client_id, params, base_version,
        n_samples, t)`` in event order; returns one downlink list per upload,
        what sequential ``handle_upload`` calls would return.

        Uploads go in segments of consecutive distinct clients, each one
        ``ingest_chain`` launch (:meth:`_handle_upload_segment`). The seeding
        phase, the clustering ablation, a repeated client, a segment of one
        upload and the pytree backend take the per-upload path."""
        out: list[list[Downlink]] = []
        i, n = 0, len(batch)
        while i < n:
            cl = self.clustering
            if cl.plane is None or not self.enable_clustering or len(cl.clusters) < cl.num_initial:
                out.append(self.handle_upload(*batch[i]))
                i += 1
                continue
            seen: set = set()
            j = i
            while j < n and batch[j][0] not in seen:
                seen.add(batch[j][0])
                j += 1
            if j - i < 2:
                out.append(self.handle_upload(*batch[i]))
                i += 1
                continue
            seg_out, consumed = self._handle_upload_segment(batch[i:j])
            out.extend(seg_out)
            i += consumed
        return out

    def _prev_forced(self, seg: list[tuple], start: int, pos: dict) -> tuple[list[int], list[int]]:
        """Each upload's previous cluster and, for a partial-finetune member,
        the cluster it is pinned to, as indices into ``pos`` (-1: none)."""
        cl = self.clustering
        prev_idx, forced_idx = [], []
        for item in seg[start:]:
            prev = cl.assignment.get(item[0])
            alive = prev is not None and prev in cl.clusters
            pinned = alive and item[0] in cl.clusters[prev].partial_finetune
            prev_idx.append(pos[prev] if alive else -1)
            forced_idx.append(pos[prev] if pinned else -1)
        return prev_idx, forced_idx

    def _handle_upload_segment(self, seg: list[tuple]) -> tuple[list[list[Downlink]], int]:
        """One segment of :meth:`handle_uploads`: one ``ingest_chain`` launch,
        one host copy of its cids, statistics and blended rows, then the
        per-upload bookkeeping replayed from them. The launch spans refine
        boundaries speculatively: a refine that changed the cluster set or an
        upload's prev/forced index stops the replay, and the caller
        relaunches the rest from live state. Returns ``(downlink lists,
        uploads consumed)``.

        With a guard the chain also returns each step's post-blend center
        norm, in the same host copy. Each sub-window walks the norms in step
        order before planning; a failed check at step ``f`` ends the
        sub-window there: the predictor plans ``[j0, f)``, step ``f`` blends,
        rolls back and never reaches the predictor, and the caller relaunches
        the uploads after ``f`` from the restored state."""
        cl = self.clustering
        plane = cl.plane
        cid_order = sorted(cl.clusters)
        pos = {c: k for k, c in enumerate(cid_order)}
        S = len(seg)
        guard = self.guard

        U = torch.stack([plane.from_pytree(item[1]) for item in seg])  # one flatten per upload
        prev_idx, forced_idx = self._prev_forced(seg, 0, pos)

        res = K.ingest_chain(
            U, plane.rows([cl.clusters[c]._row for c in cid_order]),
            plane.rows([cl.clusters[c]._bcast_row for c in cid_order]),
            prev_idx, forced_idx, beta=cl.mix_rate, with_stats=guard is not None,
        )
        cids_np, blended, stats = res.host()  # the segment's one host sync
        change_np, gb_np, ga_np = stats[:, 0], stats[:, 1], stats[:, 2]
        blended.flags.writeable = False

        step_cids = [cid_order[int(cids_np[j])] for j in range(S)]
        out: list[list[Downlink]] = []
        last_vec: dict[int, np.ndarray] = {}  # cid -> live center row (host)
        bcast_np: dict[int, np.ndarray] = {}  # cid -> anchor moved mid-segment (host)
        j0 = 0
        while j0 < S:
            # predictor sub-window: up to and including the next refine
            # boundary, whose predictor maintenance must see the weights as
            # of refine time
            j1 = min(S, j0 + self.refine_every - (self._uploads % self.refine_every))
            # the guard's walk of the post-blend norms, in step order, before
            # anything is planned: a failure at f voids the launch from f on
            fail = None
            if guard is not None:
                fail = next((j for j in range(j0, j1) if not guard.center_ok(step_cids[j], float(stats[j, 3]))),
                            None)
            j_end = j1 if fail is None else fail + 1
            # the sub-window's upload rows in one write: a refine, which
            # reads them, only comes at its end
            rows = []
            for item in seg[j0:j_end]:
                row = cl.uploads.get(item[0])
                if row is None:
                    row = cl.uploads[item[0]] = plane.alloc()
                rows.append(row)
            plane.write_rows(rows, U[j0:j_end])
            j_plan = j1 if fail is None else fail  # the failed step never reaches the predictor
            plan = (
                self._plan_predictor_window(seg, j0, j_plan, step_cids, forced_idx, change_np, gb_np, ga_np,
                                            blended, bcast_np, last_vec)
                if self.enable_broadcast and j_plan > j0 else None
            )
            for j in range(j0, j_end):
                client_id = seg[j][0]
                self._uploads += 1
                msgs: list[Downlink] = []
                cid = step_cids[j]
                cluster = cl.clusters[cid]
                if forced_idx[j] < 0:  # partial-finetune members stay put
                    cl._move(client_id, cid)
                try:
                    branch = self.repo.branch(f"cluster/{cid}")
                except KeyError:
                    branch = self.repo.branch(f"cluster/{cid}", cluster.center_vec)
                staleness = self._staleness(client_id, cid, cluster)
                pred = self._predictor(cid) if self.enable_broadcast else None
                new_vec = blended[j]

                def merge_fn(head, cluster=cluster, vec=res.blended[j]):
                    cluster.set_center_vec(vec)
                    cluster.version += 1
                    return cluster.center_vec

                branch.push(client_id, merge_fn, f"upload from {client_id} (staleness {staleness})")

                if j == fail:
                    # the carried centers are corrupt from here on: roll back
                    # and hand the rest back for a relaunch from live state
                    msgs.extend(self._rollback_center(cluster, branch, client_id))
                    if self._uploads % self.refine_every == 0:
                        msgs.extend(self._refine())
                    out.append(msgs)
                    cl._pending = None
                    return out, j + 1

                if pred is not None:  # the plan's chain already took the SGD steps
                    pred.observe(float(change_np[j]))

                # unicast payload: a device view of the launch's blended row
                msgs.append(Downlink(client_id, plane.spec.unflatten(res.blended[j]), cluster.version, cid,
                                     "unicast"))
                self.client_versions[client_id] = (cid, cluster.version)

                if pred is not None and cluster.size > 1:
                    self._decisions += 1
                    if pred.apply_decision(plan.wants[j]):
                        self._rnn_broadcasts += 1
                        msgs.extend(self._broadcast(cluster, exclude={client_id}))
                        bcast_np[cid] = new_vec  # the anchor is now this row
                last_vec[cid] = new_vec

                if j == j_plan - 1 and plan is not None:
                    # the chain's final weights, before a refine inherits them
                    for wcid, wparams in plan.new_params.items():
                        self.predictors[wcid].params = wparams
                if self._uploads % self.refine_every == 0:
                    msgs.extend(self._refine())
                    out.append(msgs)
                    if j + 1 < S and not self._segment_continuation_valid(
                        seg, j + 1, cid_order, prev_idx, forced_idx
                    ):
                        cl._pending = None
                        return out, j + 1
                else:
                    out.append(msgs)
            j0 = j1
        cl._pending = None  # the segment never uses the assign-time cache
        return out, S

    def _segment_continuation_valid(self, seg: list[tuple], start: int, cid_order: list, prev_idx: list,
                                    forced_idx: list) -> bool:
        """After a mid-segment refine: does the launch still hold for the
        uploads from ``start`` on? It fixed the cluster set (expansion,
        merge and dissolve change it) and each upload's prev/forced index
        (feedback reassignment and lifted pins change those)."""
        if sorted(self.clustering.clusters) != cid_order:
            return False
        prev_now, forced_now = self._prev_forced(seg, start, {c: k for k, c in enumerate(cid_order)})
        return prev_now == prev_idx[start:] and forced_now == forced_idx[start:]

    def _plan_predictor_window(self, seg, j0, j1, step_cids, forced_idx, change_np, gb_np, ga_np, blended,
                               bcast_np, last_vec) -> _PredictorPlan:
        """One refinement sub-window's predictor work as one
        ``predictor_chain`` per touched cluster and one decision sync.

        A structure pass replays membership and record evolution on the
        host without touching live state: the gates (learn: records
        nonempty; decide: cluster size > 1, by kind) do not depend on
        decisions. Only the Eq. 4 labels and the cold-start fallback
        decisions depend on the broadcast anchor, which within a window is
        the window-start anchor or the blended row of an earlier fired step
        of the same cluster; so each is tabulated for every "last fired
        position" in host float64/float32 arithmetic, and the chain gathers
        from the tables on the device. ``resolve`` replays the host
        bookkeeping under the synced RNN decisions."""
        cl = self.clustering

        # ---- structure pass: decision-independent step data
        sim_size: dict[int, int] = {}
        sim_assign: dict[Any, int] = {}
        shadows: dict[int, BroadcastPredictor] = {}  # cid -> predictor state advanced by the pass

        def size_of(c):
            return sim_size.get(c, cl.clusters[c].size)

        def pred_of(c):
            ps = shadows.get(c)
            if ps is None:
                live = self.predictors.get(c)
                # _predictor() creates one at first touch, k from the live size
                ps = shadows[c] = (live.shadow() if live is not None else
                                   BroadcastPredictor(params=self._rnn_init, k=max(self.top_k, size_of(c))))
            return ps

        steps = []
        for j in range(j0, j1):
            client = seg[j][0]
            cid = step_cids[j]
            if forced_idx[j] < 0:  # mirror cl._move's size effects
                prev = sim_assign.get(client, cl.assignment.get(client))
                if prev != cid:
                    if prev is not None and prev in cl.clusters:
                        sim_size[prev] = size_of(prev) - 1
                    sim_size[cid] = size_of(cid) + 1
                sim_assign[client] = cid
            ps = pred_of(cid)
            change = float(change_np[j])
            learn_gate = len(ps.records) > 0
            seq_pre = build_seq(ps.records, ps.k) if learn_gate else None
            ps.observe(change)
            kind = ps.decision_kind() if size_of(cid) > 1 else "none"
            seq_post = build_seq(ps.records, ps.k) if kind == "rnn" else None
            steps.append({"j": j, "cid": cid, "change": change, "learn": learn_gate, "seq_pre": seq_pre,
                          "kind": kind, "seq_post": seq_post, "scale": ps.scale})

        # ---- labels and decisions under a set of RNN outcomes
        def resolve(rnn_wants: dict) -> dict:
            anchors = dict(bcast_np)
            wants: dict[int, bool] = {}
            for st in steps:
                j, cid = st["j"], st["cid"]
                a = anchors.get(cid)
                want = False
                if st["kind"] == "fallback":
                    gap = float(ga_np[j]) if a is None else float(np.abs(blended[j] - a).sum(dtype=np.float32))
                    want = BroadcastPredictor.fallback_wants(gap, st["scale"])
                elif st["kind"] == "rnn":
                    want = bool(rnn_wants.get(j, False))
                wants[j] = want
                if want:
                    anchors[cid] = blended[j]
            return wants

        # ---- one chain per cluster that learns or decides by the RNN
        chains: dict[int, list] = {}
        for st in steps:
            if st["learn"] or st["kind"] in ("rnn", "fallback"):
                chains.setdefault(st["cid"], []).append(st)
        launch_cids = [c for c in sorted(chains) if any(st["learn"] or st["kind"] == "rnn" for st in chains[c])]
        if not launch_cids:  # no device work this window
            return _PredictorPlan(wants=resolve({}), new_params={})

        # the last-upload row each step sees before it runs (moves at every
        # step of its cluster, in a chain or not)
        lastv_sim = dict(last_vec)
        lastv_before: dict[int, Any] = {}
        for st in steps:
            lastv_before[st["j"]] = lastv_sim.get(st["cid"])
            lastv_sim[st["cid"]] = blended[st["j"]]

        wants_dev: dict[int, torch.Tensor] = {}
        finals: dict[int, dict] = {}
        for c in launch_cids:
            sub = chains[c]
            k, L = pred_of(c).k, len(sub)
            pre = np.zeros((L, k, 1), np.float32)
            post = np.zeros((L, k, 1), np.float32)
            lab_t = np.zeros((L, L + 1), np.int64)
            fb_t = np.zeros((L, L + 1), bool)
            lgate, dgate, fgate = np.zeros(L, bool), np.zeros(L, bool), np.zeros(L, bool)
            anchor0 = bcast_np.get(c)
            for p, st in enumerate(sub):
                j = st["j"]
                lv = lastv_before[j]
                # anchors live when step p runs: column 0 the window-start
                # anchor, column q + 1 chain step q fired last
                cand = [(0, anchor0)] + [(q + 1, blended[sub[q]["j"]]) for q in range(p)
                                         if sub[q]["kind"] in ("rnn", "fallback")]
                if st["learn"]:
                    pre[p] = st["seq_pre"]
                    lgate[p] = True
                    for col, a in cand:
                        gb = float(gb_np[j]) if a is None else float(np.abs(lv - a).sum(dtype=np.float32))
                        lab_t[p, col] = 1 if st["change"] > gb else 0
                if st["kind"] == "rnn":
                    post[p] = st["seq_post"]
                    dgate[p] = True
                elif st["kind"] == "fallback":
                    fgate[p] = True
                    for col, a in cand:
                        ga = float(ga_np[j]) if a is None else float(np.abs(blended[j] - a).sum(dtype=np.float32))
                        fb_t[p, col] = BroadcastPredictor.fallback_wants(ga, st["scale"])
            finals[c], w = predictor_chain(pred_of(c).params, pre, post, lab_t, fb_t, lgate, dgate, fgate)
            if dgate.any():
                wants_dev[c] = w

        used: dict[int, bool] = {}
        if wants_dev:
            w_host = torch.cat(list(wants_dev.values())).cpu().numpy()  # the window's one decision sync
            o = 0
            for c, w in wants_dev.items():
                for p, st in enumerate(chains[c]):
                    if st["kind"] == "rnn":
                        used[st["j"]] = bool(w_host[o + p])
                o += len(w)
        new_params = {c: finals[c] for c in launch_cids if any(st["learn"] for st in chains[c])}
        return _PredictorPlan(wants=resolve(used), new_params=new_params)

    def _center_norm(self, cluster) -> float:
        """The post-blend center L1 norm of the per-event late check: the
        host's fp32 numpy sum of the center row, as the reference takes it
        (one device-to-host copy an upload on the card); in tree mode that of
        the flattened center tree."""
        return float(np.abs(cluster.center_vec.cpu().numpy()).sum())

    def _rollback_center(self, cluster, branch, client_id) -> list[Downlink]:
        """The late check failed: restore the newest finite snapshot (or
        the anchor), record the recovery on the branch and re-broadcast to
        every member, the uploader included. If every recorded state is
        itself corrupt nothing is restored and nothing is sent; the ledger
        counts the detection either way."""
        cid = cluster.cluster_id
        self.guard.note_rollback()
        if not cluster.rollback():
            self.events.append({"kind": "rollback", "cluster": cid, "restored": False})
            return []

        def merge_fn(head):
            cluster.version += 1
            return cluster.head

        branch.push(client_id, merge_fn, f"center rollback after poisoned blend from {client_id}")
        self.events.append({"kind": "rollback", "cluster": cid, "restored": True})
        return self._broadcast(cluster)

    def _broadcast(self, cluster, exclude: set = frozenset()) -> list[Downlink]:
        cluster.snapshot_broadcast()
        cluster.last_broadcast_version = cluster.version
        msgs = []
        for member in cluster.members - exclude:
            msgs.append(Downlink(member, cluster.center, cluster.version, cluster.cluster_id, "broadcast"))
            self.client_versions[member] = (cluster.cluster_id, cluster.version)
        self.events.append({"kind": "broadcast", "cluster": cluster.cluster_id, "n": len(msgs)})
        return msgs

    # ---------------------------------------------------------- refinement
    def _feedback_rows(self, pairs: list) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(F_pred, F_true, S_soft) for (client, center) pairs as fp32 device
        tensors: one batched probe when ``feedback_batch_fn`` is installed,
        else one ``feedback_fn`` call per pair."""
        dev = self.device
        if self.feedback_batch_fn is not None:
            f_pred, f_true, s_soft = self.feedback_batch_fn(list(pairs))
        else:
            rows = [self.feedback_fn(m, center) for m, center in pairs]
            f_pred = np.stack([r[0] for r in rows])
            f_true = np.stack([r[1] for r in rows])
            s_soft = np.stack([r[2] for r in rows])

        def as_dev(x):
            return torch.as_tensor(x, dtype=torch.float32).to(dev).contiguous()

        return as_dev(f_pred), torch.clamp_min(as_dev(f_true), 1e-3), as_dev(s_soft)

    def _collect_feedback(self) -> dict[int, dict[Any, float]]:
        """chi2 x Var(S) feedback for every member of every cluster in one
        segmented launch, which also sums g per cluster."""
        if self.feedback_fn is None:
            return {}
        cid_order = sorted(self.clustering.clusters)
        entries: list[tuple[int, int, Any, Any]] = []  # (segment, cid, member, center)
        for si, cid in enumerate(cid_order):
            cluster = self.clustering.clusters[cid]
            center = cluster.center  # materialized once per cluster
            for m in sorted(cluster.members):
                entries.append((si, cid, m, center))
        if not entries:
            return {}
        f_pred, f_true, s_soft = self._feedback_rows([(m, c) for _, _, m, c in entries])
        seg_ids = np.asarray([si for si, _, _, _ in entries], np.int32)
        g, seg_sum = K.chi2_feedback_segmented(
            f_pred, f_true, s_soft, torch.from_numpy(seg_ids).to(self.device),
            num_segments=len(cid_order), **self.clustering.launch_kwargs(len(entries)),
        )
        g, seg_sum = segmented_numpy(g, seg_sum)  # one device-to-host copy
        counts = np.bincount(seg_ids, minlength=len(cid_order))
        self.last_cluster_feedback_mean = {
            cid: float(seg_sum[si] / counts[si])
            for si, cid in enumerate(cid_order)
            if counts[si] > 0
        }
        per_cluster: dict[int, dict[Any, float]] = {}
        for (si, cid, m, _), gi in zip(entries, g.tolist()):
            per_cluster.setdefault(cid, {})[m] = gi
        return per_cluster

    def _reassign_by_feedback(self, feedback: dict[int, dict[Any, float]]) -> int:
        """Probe every flagged poor-fit member's feedback against every other
        center in one launch and move it to a decisively better fit."""
        clusters = self.clustering.clusters
        if self.feedback_fn is None or len(clusters) < 2:
            return 0
        flagged: list[tuple[Any, int, float]] = []
        for cid, fb in feedback.items():
            if cid not in clusters or len(fb) < 2:
                continue
            med = float(np.median(list(fb.values())))
            for m, g in fb.items():
                if g <= 2.0 * (med + 1e-12):
                    continue
                if m in clusters[cid].partial_finetune:
                    continue
                flagged.append((m, cid, g))
        if not flagged:
            return 0
        centers = {cid: clusters[cid].center for cid in clusters}
        others_of = {
            home: [c2 for c2 in sorted(clusters) if c2 != home]
            for home in {home for _, home, _ in flagged}
        }
        pairs = [(m, centers[c2]) for m, home, _ in flagged for c2 in others_of[home]]
        f_pred, f_true, s_soft = self._feedback_rows(pairs)
        scores = K.chi2_feedback(
            f_pred, f_true, s_soft, **self.clustering.launch_kwargs(len(pairs))
        ).cpu().numpy().reshape(len(flagged), len(clusters) - 1)
        moves = 0
        for (m, home, g), row in zip(flagged, scores):
            best_i = int(np.argmin(row))
            if row[best_i] < 0.5 * g:
                best = others_of[home][best_i]
                self.clustering._move(m, best)
                self.client_versions[m] = (best, clusters[best].version)
                moves += 1
        return moves

    def _refine(self) -> list[Downlink]:
        out: list[Downlink] = []
        if not self.enable_clustering:
            return out
        self._refine_round += 1
        if self._refine_round % 5 == 0:  # decay peel counts
            self.clustering.peel_counts = {
                k: v - 1 for k, v in self.clustering.peel_counts.items() if v > 1
            }
        # lift head-only mode imposed before this refinement (Sec. 4.3.3)
        for cluster in self.clustering.clusters.values():
            if cluster.partial_finetune and cluster.pf_round < self._refine_round - 1:
                cluster.partial_finetune.clear()
        feedback = self._collect_feedback()

        # first move poor fits to an existing better-fitting cluster
        moved = self._reassign_by_feedback(feedback)
        if moved:
            self.events.append({"kind": "reassign", "n": moved})
            feedback = self._collect_feedback()

        # expansion: split poor fits out of each cluster
        for cid, fb in list(feedback.items()):
            if cid not in self.clustering.clusters:
                continue
            new_cid = self.clustering.expand(
                cid, fb, uploads=self.clustering.uploads, refine_round=self._refine_round,
            )
            if new_cid is not None:
                parent_pred = self._predictor(cid)
                new_cluster = self.clustering.clusters[new_cid]
                change = max(fb.values()) if fb else 0.0
                self.predictors[new_cid] = predictor_for_expansion(parent_pred, change)
                self.repo.branch(f"cluster/{new_cid}", new_cluster.center)
                self.events.append({"kind": "expand", "from": cid, "to": new_cid})
                for m in new_cluster.members:
                    self.client_versions[m] = (new_cid, new_cluster.version)

        # merging: above hm * C clusters, fold the nearest redundant pair,
        # else dissolve the smallest cluster
        while self.clustering.should_merge():
            pair = self.clustering.nearest_pair()
            if pair is None:
                if not self._dissolve_smallest():
                    break
                continue
            a, b = pair
            pred_a, pred_b = self._predictor(a), self._predictor(b)  # before deletion
            train_fn = self.local_train_fn or (lambda p: p)
            merged_cid = self.clustering.merge_pair(a, b, train_fn)
            other = b if merged_cid == a else a
            self.predictors[merged_cid] = predictor_for_merge(pred_a, pred_b)
            self.predictors.pop(other, None)
            self.repo.delete(f"cluster/{other}")
            self.repo.branch(f"cluster/{merged_cid}", self.clustering.clusters[merged_cid].center)
            self.events.append({"kind": "merge", "into": merged_cid, "from": other})
            # merged model is immediately broadcast (Sec. 5.2.2)
            out.extend(self._broadcast(self.clustering.clusters[merged_cid]))
        return out

    def _dissolve_smallest(self) -> bool:
        """Retire the smallest cluster and refit each member to its best
        remaining cluster (feedback probe when available, else L1 of its last
        upload), every probe in one launch."""
        clustering = self.clustering
        clusters = clustering.clusters
        if len(clusters) < 2:
            return False
        victim = min(clusters, key=lambda c: (clusters[c].size, clusters[c].version))
        rest = [c for c in clusters if c != victim]
        members = sorted(clusters[victim].members, key=str)
        best_of: dict[Any, int] = {m: rest[0] for m in members}
        if members and self.feedback_fn is not None:
            centers = {c: clusters[c].center for c in rest}
            f_pred, f_true, s_soft = self._feedback_rows(
                [(m, centers[c]) for m in members for c in rest]
            )
            scores = K.chi2_feedback(
                f_pred, f_true, s_soft, **clustering.launch_kwargs(len(f_pred))
            ).cpu().numpy().reshape(len(members), len(rest))
            for m, row in zip(members, scores):
                best_of[m] = rest[int(np.argmin(row))]
        elif members:
            best_of.update(clustering.nearest_centers(members, rest))
        for m in members:
            best = best_of[m]
            clustering._move(m, best)
            self.client_versions[m] = (best, clusters[best].version)
        clustering.drop_cluster(victim)
        self.predictors.pop(victim, None)
        self.repo.delete(f"cluster/{victim}")
        self.events.append({"kind": "dissolve", "cluster": victim})
        return True

    # --------------------------------------------------------------- eviction
    def evict_clients(self, client_ids: list) -> dict:
        """Remove clients gone dark for good (device death, the drop policy,
        or the guard's eviction): free each one's upload row and its codec
        rows, drop its bookkeeping, and reclaim a cluster left with no
        member (its center, anchor and ring rows, predictor and branch),
        except cluster 0 with clustering off, which every upload goes to.
        Returns ``{"evicted": [...], "reclaimed": [cluster ids]}``."""
        cl = self.clustering
        evicted: list = []
        reclaimed: list[int] = []
        for client_id in client_ids:
            touched = False
            if self.uplink_codec is not None:
                self.uplink_codec.release_client(client_id)
            if cl.drop_upload(client_id):
                touched = True
            self.client_versions.pop(client_id, None)
            home = cl.assignment.pop(client_id, None)
            if home is not None and home in cl.clusters:
                touched = True
                cluster = cl.clusters[home]
                cluster.members.discard(client_id)
                cluster.partial_finetune.discard(client_id)
                if not cluster.members and self.enable_clustering:
                    cl.drop_cluster(home)
                    self.predictors.pop(home, None)
                    self.repo.delete(f"cluster/{home}")
                    reclaimed.append(home)
            if touched:
                evicted.append(client_id)
                self.events.append({"kind": "evict", "client": str(client_id)})
        for home in reclaimed:
            self.events.append({"kind": "reclaim", "cluster": home})
        return {"evicted": evicted, "reclaimed": reclaimed}

    # ------------------------------------------------- checkpoint and restart
    def state_dict(self) -> tuple[PyTree, dict]:
        """``(tree, meta)``: every piece of state the protocol accumulates,
        the reference's layout. The tree holds the cluster centers and
        broadcast anchors, each client's last upload (the expansion and
        dissolve geometry), each predictor's RNN weights and, with a codec,
        its rows; leaves are copies of the plane rows (in tree mode the trees
        themselves) and the live RNN tensors. The meta is JSON (Python ints, floats, strings, bools,
        lists, dicts): membership, versions, the staleness counters, the
        Top-K records and the counters and histories :meth:`stats` reads.
        :meth:`load_state` restores it."""
        cl = self.clustering
        last_uploads = {str(k): cl.upload_tree(k) for k in cl.uploads}
        tree = {
            "centers": {str(cid): c.center for cid, c in cl.clusters.items()},
            "bcast_centers": {str(cid): c.last_broadcast_center for cid, c in cl.clusters.items()},
            "last_uploads": last_uploads,
            "rnn": {str(cid): p.params for cid, p in self.predictors.items()},
        }
        meta = {
            "clusters": {
                str(cid): {
                    "version": c.version,
                    "members": sorted(map(str, c.members)),
                    "partial_finetune": sorted(map(str, c.partial_finetune)),
                    "pf_round": c.pf_round,
                    "last_broadcast_version": c.last_broadcast_version,
                }
                for cid, c in cl.clusters.items()
            },
            "assignment": {str(k): v for k, v in cl.assignment.items()},
            "next_id": cl._next_id,
            "merges": cl.merges,
            "expansions": cl.expansions,
            "peel_counts": {str(k): v for k, v in cl.peel_counts.items()},
            "predictors": {
                str(cid): {"k": p.k, "records": list(p.records), "active": p.active, "scale": p.scale,
                           "decisions": p.decisions, "broadcasts": p.broadcasts}
                for cid, p in self.predictors.items()
            },
            "staleness": {"count": self.staleness.count, "total": self.staleness.total,
                          "q_max": self.staleness.q_max},
            "client_versions": {str(k): list(v) for k, v in self.client_versions.items()},
            "uploads": self._uploads,
            "decisions": self._decisions,
            "rnn_broadcasts": self._rnn_broadcasts,
            "refine_round": self._refine_round,
            "upload_clients": sorted(last_uploads),
            # what an exact restart needs besides: the expansion cooldown
            # gates refine decisions, the events and feedback means feed stats()
            "last_expand_round": {str(k): v for k, v in cl._last_expand_round.items()},
            "events": [dict(e) for e in self.events],
            "cluster_feedback_mean": {str(k): v for k, v in self.last_cluster_feedback_mean.items()},
        }
        if self.uplink_codec is not None:
            tree["uplink"], meta["uplink"] = self.uplink_codec.state_dict()
        return tree, meta

    def state_template(self, meta: dict) -> PyTree:
        """A tree of :meth:`state_dict`'s structure for ``meta``, for the
        checkpointer's restore: centers, anchors and uploads share the
        initial model's structure, predictors the RNN's."""
        from repro_torch.fl.uplink import seed_template

        # with the broadcast ablation the predictors hold no weights, and
        # their entries no leaves (the reference's template gives them RNN
        # leaves, so its own restart of such a server fails)
        rnn_like = self._rnn_init
        template = {
            "centers": {cid: self.init_params for cid in meta["clusters"]},
            "bcast_centers": {cid: self.init_params for cid in meta["clusters"]},
            "last_uploads": {c: self.init_params for c in meta.get("upload_clients", [])},
            "rnn": {cid: rnn_like for cid in meta["predictors"]},
        }
        if meta.get("uplink"):
            template["uplink"] = seed_template(meta["uplink"], self.init_params)
        return template

    def load_state(self, tree: PyTree, meta: dict, client_id_type=int) -> None:
        """Restore from :meth:`state_dict`'s output, or from a checkpoint of
        it (numpy leaves; either package's). The old upload rows and
        clusters go first; clusters come back in the meta's order, then the
        upload rows, so rows are claimed as in the reference. A snapshot
        ring is not part of the state: :meth:`attach_guard` gives a
        restored server empty rings."""
        cid_of = client_id_type
        cl = self.clustering
        cl.reset()
        for cid_s, info in meta["clusters"].items():
            cid = int(cid_s)
            c = cl.restore_cluster(cid, tree["centers"][cid_s], tree["bcast_centers"][cid_s])
            c.version = info["version"]
            c.members = {cid_of(m) for m in info["members"]}
            c.partial_finetune = {cid_of(m) for m in info["partial_finetune"]}
            c.pf_round = info["pf_round"]
            c.last_broadcast_version = info["last_broadcast_version"]
            self.repo.branch(f"cluster/{cid}", c.head)
        for k, v in (tree.get("last_uploads") or {}).items():
            cl.restore_upload(cid_of(k), v)
        cl.assignment = {cid_of(k): v for k, v in meta["assignment"].items()}
        cl._next_id = meta["next_id"]
        cl.merges = meta["merges"]
        cl.expansions = meta["expansions"]
        cl.peel_counts = {cid_of(k): v for k, v in meta["peel_counts"].items()}
        self.predictors = {}
        for cid_s, info in meta["predictors"].items():
            raw = tree["rnn"][cid_s]
            params = None if raw is None else {k: on_device(v, self.device) for k, v in raw.items()}
            p = BroadcastPredictor(params=params, k=info["k"])
            p.records = list(info["records"])
            p.active = info["active"]
            p.scale = info["scale"]
            p.decisions = info["decisions"]
            p.broadcasts = info["broadcasts"]
            self.predictors[int(cid_s)] = p
        st = meta["staleness"]
        self.staleness.count, self.staleness.total, self.staleness.q_max = st["count"], st["total"], st["q_max"]
        self.client_versions = {cid_of(k): tuple(v) for k, v in meta["client_versions"].items()}
        self._uploads = meta["uploads"]
        self._decisions = meta["decisions"]
        self._rnn_broadcasts = meta["rnn_broadcasts"]
        self._refine_round = meta["refine_round"]
        cl._last_expand_round = {int(k): v for k, v in meta.get("last_expand_round", {}).items()}
        self.events = [dict(e) for e in meta.get("events", [])]
        self.last_cluster_feedback_mean = {int(k): v for k, v in meta.get("cluster_feedback_mean", {}).items()}
        self._pending_uplink_state = None
        if meta.get("uplink"):
            if self.uplink_codec is not None:
                self.uplink_codec.load_state(tree["uplink"], meta["uplink"], client_id_type)
            else:  # the codec comes with the next run's fleet: replayed at attach
                self._pending_uplink_state = (tree["uplink"], meta["uplink"], client_id_type)

    # ------------------------------------------------------------- metrics
    def stats(self) -> dict:
        plane = self.clustering.plane
        return {
            "clusters": len(self.clustering.clusters),
            "merges": self.clustering.merges,
            "expansions": self.clustering.expansions,
            "staleness": self.staleness.snapshot(),
            "broadcasts": sum(1 for e in self.events if e["kind"] == "broadcast"),
            "rnn_broadcasts": self._rnn_broadcasts,
            "decisions": self._decisions,
            "backend": self.clustering.backend,
            "plane_rows": 0 if plane is None else plane.num_allocated,
            "cluster_feedback_mean": {
                cid: g
                for cid, g in self.last_cluster_feedback_mean.items()
                if cid in self.clustering.clusters
            },
        }
