"""The recurrent archs on model meshes: reduced jamba-1.5-large-398b
(Mamba, attention, MoE) and xlstm-1.3b (mLSTM, sLSTM), the port's sharded
forward, prefill, decode and train step against the reference's sharded
step functions (``torch_model_mesh_common``: a child interpreter on a
forced 8-device host, ``Auto`` axes, the port's weights), on the (2, 4),
(2, 2, 2) and (4, 2) meshes.

* jamba: forward and prefill logits within 3e-5 of the reference's and of
  the unmeshed port's (the reference's own meshed-against-unmeshed gap is
  2.1e-5 at most); greedy tokens equal.
* xlstm: reduced xLSTM is chaotic in fp32 (PERF.md; ``tests/torch_zoo.py``
  holds its full model to 3 times the spread one ulp of noise makes).
  Its logits are held to the reference's and to the unmeshed port's
  within XLSTM_FACTOR times the reference's own meshed-against-unmeshed
  gap on that mesh (REFERENCE_GAP: this recipe's reference run against the
  same run on a 1 x 1 mesh, jax 0.9.0, the larger of the forward's and the
  prefill's max |logits| difference).
* One train step: the loss within 1e-6 relative (jamba) or 1e-5 (xlstm);
  every parameter within PARAMS_ATOL of the reference's and the unmeshed
  port's: jamba's Adafactor and xlstm's AdamW move a weight by about the
  learning rate wherever the gradient's sign holds, and a gradient near
  zero may round to either sign, in the reference's own sharded step too
  (its own meshed-against-unmeshed gap is 6.0e-4 for both archs). That
  check cannot see a wrong backward whose step keeps each gradient's sign
  (AdamW's first step moves every weight by about its learning rate), so
* the first step's gradients are held leaf by leaf, each leaf's max
  |difference| over its max |g|, to the reference's meshed run and the
  unmeshed port's: jamba within 1e-4 (its gaps are some 1.4e-5, the
  reference's own 1.0e-5), xlstm
  within XLSTM_FACTOR times the reference's own meshed-against-unmeshed
  gradient gap on that mesh (GRAD_REFERENCE_GAP, measured as
  REFERENCE_GAP is). This is what holds the meshed Mamba, mLSTM and sLSTM
  backward passes.
* Each split of the placement table is exercised, named by its leaf: the
  Mamba and mLSTM up projections' halves, their row-parallel projections,
  Mamba's channel-local scan and the sLSTM's channel-split recurrence.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.common.pytrees import tree_leaves
from repro_torch.launch import sharded
from repro_torch.models import dist
from repro_torch.models import layers as L
from repro_torch.models.steps import make_prefill_step
from torch_model_mesh_common import MESHES, config, grad_gaps, inputs, place, port_mesh, port_run, reference_runs, weights
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

CASES = ("jamba-1.5-large-398b", "xlstm-1.3b")
CASE_IDS = [(a, m) for a in CASES for m in MESHES]
JAMBA_ATOL = 3e-5
# the reference's own max |logits| gap, meshed against unmeshed (forward and prefill), per mesh
REFERENCE_GAP = {"2x4": 8.3e-4, "2x2x2": 3.6e-4, "4x2": 3.6e-4}
XLSTM_FACTOR = 3
JAMBA_GRAD_RTOL = 1e-4
# the reference's own worst leaf gap of the first step's gradients (max |difference| over max |g|), meshed against
# unmeshed, per mesh
GRAD_REFERENCE_GAP = {"2x4": 2.1e-3, "2x2x2": 1.2e-3, "4x2": 1.2e-3}
PARAMS_ATOL = {"jamba-1.5-large-398b": 1e-3, "xlstm-1.3b": 1e-3}
LOSS_RTOL = {"jamba-1.5-large-398b": 1e-6, "xlstm-1.3b": 1e-5}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref = reference_runs(CASE_IDS, tmp_path_factory.mktemp("zoo_mesh_ssm"), grads=True)
    return {"reference": ref, "port": {key: port_run(*key, grads=True) for key in CASE_IDS},
            "single": {arch: port_run(arch, None, grads=True) for arch in CASES}}


def logits_atol(arch: str, mesh: str) -> float:
    return JAMBA_ATOL if arch.startswith("jamba") else XLSTM_FACTOR * REFERENCE_GAP[mesh]


def grad_rtol(arch: str, mesh: str) -> float:
    return JAMBA_GRAD_RTOL if arch.startswith("jamba") else XLSTM_FACTOR * GRAD_REFERENCE_GAP[mesh]


@pytest.mark.parametrize("arch,mesh", CASE_IDS)
def test_sharded_forward_and_prefill_match_the_reference(runs, arch, mesh):
    got, want, single = runs["port"][(arch, mesh)], runs["reference"][(arch, mesh)], runs["single"][arch]
    for key in ("forward", "prefill"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=logits_atol(arch, mesh))
        np.testing.assert_allclose(got[key], single[key], rtol=0, atol=logits_atol(arch, mesh))


@pytest.mark.parametrize("arch,mesh", CASE_IDS)
def test_sharded_decode_tokens_equal_the_references(runs, arch, mesh):
    got = runs["port"][(arch, mesh)]["tokens"]
    np.testing.assert_array_equal(got, runs["reference"][(arch, mesh)]["tokens"])
    np.testing.assert_array_equal(got, runs["single"][arch]["tokens"])


@pytest.mark.parametrize("arch,mesh", CASE_IDS)
def test_sharded_train_step_matches_the_reference(runs, arch, mesh):
    got, want, single = runs["port"][(arch, mesh)], runs["reference"][(arch, mesh)], runs["single"][arch]
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL[arch] * abs(want["loss"])
    assert abs(got["loss"] - single["loss"]) <= LOSS_RTOL[arch] * abs(single["loss"])
    for a, b, c in zip(tree_leaves(got["params"]), jax.tree_util.tree_leaves(want["params"]),
                       tree_leaves(single["params"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=PARAMS_ATOL[arch])
        np.testing.assert_allclose(a, c, rtol=0, atol=PARAMS_ATOL[arch])


@pytest.mark.parametrize("arch,mesh", CASE_IDS)
def test_sharded_first_step_gradients_match_the_reference(runs, arch, mesh):
    """The loss's gradient at the initial params through the sharded
    backward (Mamba's channel split and row-parallel ``w_x``/``w_out``, the
    mLSTM's row-parallel projections, the sLSTM's channel-split
    recurrence), leaf by leaf against the reference's meshed run and the
    unmeshed port's."""
    got = runs["port"][(arch, mesh)]["grads"]
    for want in (runs["reference"][(arch, mesh)]["grads"], runs["single"][arch]["grads"]):
        gaps = grad_gaps(got, want)
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= grad_rtol(arch, mesh), (worst, gaps[worst])


def test_every_split_kind_is_exercised():
    """On (2, 4), by leaf: jamba's ``w_in`` (2 x 128 columns in blocks of
    64: ranks 0-1 hold ``x_in``, 2-3 ``z``), its channels (``conv_w``,
    ``conv_b``, ``A_log``, ``D``, ``dt_bias``), ``w_x`` and ``w_out`` over
    rows, ``w_dt`` over columns; xlstm's ``w_up`` halves the same way, its
    per-head ``wq``/``wk``/``wv`` cut on their input dim, ``w_i``, ``w_f``,
    ``w_down`` over rows, the sLSTM's ``wgx``, ``wgh`` and ``gbias`` over
    channels. A prefill of each runs the channel-split Mamba scan and the
    channel-split sLSTM recurrence."""
    expect = {
        "jamba-1.5-large-398b": {"w_in": 1, "conv_w": 1, "conv_b": 0, "A_log": 0, "D": 0, "dt_bias": 0, "w_x": 0,
                                 "w_dt": 1, "w_out": 0},
        "xlstm-1.3b": {"w_up": 1, "wq": 1, "wk": 1, "wv": 1, "w_i": 0, "w_f": 0, "w_down": 0},
    }
    slstm = {"wgx": 2, "wgh": 2, "gbias": 1}
    mesh = port_mesh("2x4")
    views = {}
    for arch, leaves in expect.items():
        cfg = config(arch)
        views[arch] = view = sharded.view(place(cfg, weights(cfg), mesh), 0)
        mixer = view["blocks"]["slot0"]["mixer"]
        for name, dim in leaves.items():
            assert isinstance(mixer[name], dist.Ranks) and mixer[name].meta == dim, (arch, name)
        up = mixer["w_in" if "w_in" in leaves else "w_up"]
        d_inner = sum(part.shape[-1] for part in up) // 2
        assert len(up) == 4 and 2 * up[0].shape[-1] == d_inner  # x_in on ranks 0-1, z on 2-3
    mixer = views["xlstm-1.3b"]["blocks"]["slot7"]["mixer"]
    for name, dim in slstm.items():
        assert isinstance(mixer[name], dist.Ranks) and mixer[name].meta == dim, name

    seen = []
    mamba, sl = L._apply_mamba_ranks, L._apply_slstm_ranks

    def spy(fn, label):
        def run(params, x, cfg, **kw):
            seen.append((label, x.shape[1]))
            return fn(params, x, cfg, **kw)
        return run

    L._apply_mamba_ranks, L._apply_slstm_ranks = spy(mamba, "mamba"), spy(sl, "slstm")
    try:
        for arch in expect:
            cfg = config(arch)
            with dist.use_mesh(mesh):
                make_prefill_step(cfg)(place(cfg, weights(cfg), mesh),
                                       {"tokens": torch.from_numpy(inputs(cfg)["tokens"])})
    finally:
        L._apply_mamba_ranks, L._apply_slstm_ranks = mamba, sl
    assert ("mamba", inputs(config("jamba-1.5-large-398b"))["tokens"].shape[1]) in seen
    assert ("slstm", inputs(config("xlstm-1.3b"))["tokens"].shape[1]) in seen
