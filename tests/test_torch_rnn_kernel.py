"""The broadcast RNN kernel's arithmetic (``csrc/rnn.cu``), on the CPU.

The kernel runs only on a card; here its hand-written arithmetic is held,
through the numpy model ``tests/torch_rnn_model.py``, to autograd and to the
reference, and the wrappers' plain versions to the reference:

(a) the model's backpropagation through time and update, in float64 and
    float32, against autograd on the plain RNN (``kernels/rnn.py``) and
    against ``jax.grad`` of the reference's loss (the gradient its
    ``_rnn_sgd`` applies), at window lengths 1, 2, 10, 33 and 128 (the
    largest fleet a path runs has 128 clients, so k <= 128);
(b) the plain chain against the reference's ``ops.predictor_chain`` given
    the reference's ``init_rnn`` weights;
(c) the pretraining split into draw-then-train: the windows in the
    per-window loop's draw order, ``pretrain_rnn`` bit for bit that loop,
    and the trained weights against the reference's ``_rnn_sgd`` loop on
    the same windows and labels;
(d) the pretraining's fp32-against-fp64 gap, which sets the card's bound;
(e) an expanded cluster's predictor learns without touching its parent's
    weights, which it shares.

The card tests (``tests/test_torch_cuda.py -k rnn``) hold the kernel to the
plain versions at the bounds set here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rnn_model as model
from repro.core import broadcast as ref
from repro.kernels import ops as jax_ops
from repro_torch.core import broadcast as bc
from repro_torch.kernels import rnn
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

LR = 1e-2
PATH_MAX_K = 128  # k = max(top_k, cluster size) on the largest fleet a path runs (128 clients)
# (a): fp32 gradients (autograd's, XLA's) carry absolute errors of up to ~7e-7 of a leaf's largest
# gradient in elements that cancel (measured at these windows), so each leaf is held at rtol 1e-5
# plus an atol of 2e-6 times its largest |gradient|.
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-5, 2e-6


def _ref_weights(seed: int) -> dict:
    return {k: np.asarray(v) for k, v in ref.init_rnn(jax.random.PRNGKey(seed)).items()}


def _torch(w: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in w.items()}


def _rel_gap(a: dict, b: dict) -> float:
    """max over the leaves of max |a - b| / max |b|."""
    return max(float(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)).max()
                     / np.abs(np.asarray(b[k], np.float64)).max()) for k in b)


def _autograd_grads(w: dict, x: np.ndarray, label: int) -> dict:
    leaves = {k: v.requires_grad_(True) for k, v in _torch(w).items()}
    loss = -torch.log_softmax(rnn.rnn_logits(leaves, torch.from_numpy(x)), dim=-1)[label]
    return {k: g.numpy() for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values())))}


def _jax_grads(w: dict, x: np.ndarray, label: int) -> dict:
    def loss(p):
        return -jax.nn.log_softmax(ref.rnn_logits(p, jnp.asarray(x)))[label]

    g = jax.grad(loss)({k: jnp.asarray(v) for k, v in w.items()})
    return {k: np.asarray(v) for k, v in g.items()}


# ---------------------------------------------------------------------- (a)
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("T", [1, 2, 10, 33, PATH_MAX_K])
def test_hand_written_bptt_is_autograd_and_jax_grad(T, dtype):
    w = _ref_weights(T)
    rng = np.random.default_rng(T)
    x = rng.uniform(0.05, 1.0, (T, 1)).astype(np.float32)
    label = T % 2
    got, loss = model.grads(w, x, label, dtype)
    assert got["wh0"].dtype == dtype
    for name, want in (("autograd", _autograd_grads(w, x, label)), ("jax.grad", _jax_grads(w, x, label))):
        for k in model.LEAVES:
            np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL, atol=GRAD_ATOL_OF_MAX * np.abs(want[k]).max(),
                                       err_msg=f"{name} {k} T={T}")
    _, plain_loss = rnn.rnn_sgd_plain(_torch(w), torch.from_numpy(x), label, LR)
    np.testing.assert_allclose(loss, float(plain_loss), rtol=1e-6)


@pytest.mark.parametrize("T", [1, 10, 33])
def test_model_update_is_the_plain_and_reference_step(T):
    """p - lr g on every leaf: the model's float64 step against the plain
    step and the reference's ``_rnn_sgd`` at the tolerance the card step is
    held to (rtol 1e-6, atol 1e-7)."""
    w = _ref_weights(100 + T)
    x = np.random.default_rng(T).uniform(0.05, 1.0, (T, 1)).astype(np.float32)
    got, _ = model.sgd(w, x, 1, LR)
    plain, _ = rnn.rnn_sgd_plain(_torch(w), torch.from_numpy(x), 1, LR)
    jref, _ = ref._rnn_sgd({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), jnp.asarray(1), jnp.asarray(LR))
    for k in model.LEAVES:
        np.testing.assert_allclose(got[k], plain[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got[k], np.asarray(jref[k]), rtol=1e-6, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------- (b)
@pytest.mark.parametrize("k", [10, 33])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_chain_is_the_reference_chain(k, seed):
    """32 steps, mixed gates, ragged windows: identical wants, leaves within
    rtol 1e-6, atol 1e-7; the float64 model's chain takes the same
    decisions (their logit margins printed) and its leaves are within the
    card chain's tolerance, rtol 1e-5, atol 1e-6."""
    w = _ref_weights(seed)
    args = model.chain_inputs(k, 32, seed + 20)
    got, wants = rnn.rnn_chain(_torch(w), *args, LR)
    r_params, r_wants = jax_ops.predictor_chain({n: jnp.asarray(v) for n, v in w.items()}, *args[:2],
                                                args[2].astype(np.int32), *args[3:], 0, LR)
    assert wants.tolist() == [bool(x) for x in np.asarray(r_wants)]
    for name in model.LEAVES:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(r_params[name]), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    m_params, m_wants, margins = model.chain(w, *args, LR)
    assert m_wants == wants.tolist()
    decided = [abs(m) for m in margins if not np.isnan(m)]
    print(f"k {k} seed {seed}: {len(decided)} RNN decisions, smallest |logit margin| {min(decided):.3g}")
    for name in model.LEAVES:  # the card's chain tolerance
        np.testing.assert_allclose(got[name].numpy(), m_params[name], rtol=1e-5, atol=1e-6, err_msg=name)


def test_plain_chain_runs_on_meta_tensors():
    """The ``meta`` device takes the plain version: shapes only."""
    params = {k: v.to("meta") for k, v in _torch(_ref_weights(0)).items()}
    args = model.chain_inputs(10, 4, 0)
    got, wants = rnn.rnn_chain(params, *args, LR)
    assert wants.device.type == "meta" and wants.shape == (4,)
    assert {k: tuple(v.shape) for k, v in got.items()} == rnn.SHAPES


# ---------------------------------------------------------------------- (c)
def _per_window_draws(seed: int, k: int, num_states: int):
    """The per-window loop's draws: one window and its label a state, as a
    loop that trains between them takes them."""
    rng = np.random.default_rng(seed)
    for _ in range(num_states):
        decay = rng.uniform(0.6, 1.5)
        base = rng.uniform(0.5, 2.0)
        noise = rng.uniform(0.02, 0.3)
        seq = base * decay ** np.arange(k) * (1 + noise * rng.standard_normal(k))
        seq = np.abs(seq)[::-1]
        accumulated = float(np.sum(seq[-3:]))
        predicted_next = float(seq[-1] / decay)
        label = 1 if predicted_next > 1.15 * accumulated / 3 else 0
        scale = max(float(np.max(seq)), 1e-9)
        yield (seq / scale).astype(np.float32)[:, None], label


@pytest.mark.parametrize("seed", [0, 7])
def test_pretraining_draws_then_trains_as_the_per_window_loop(seed):
    """The windows and labels are the per-window loop's, in its order, and
    on the CPU ``pretrain_rnn`` is that ``_rnn_sgd`` loop bit for bit."""
    windows, labels = bc.pretrain_windows(seed, 10, 1200)
    draws = list(_per_window_draws(seed, 10, 1200))
    assert np.array_equal(windows, np.stack([w for w, _ in draws])) and labels[:, 0].tolist() == [lb for _, lb in draws]
    params = bc.init_rnn(torch.Generator().manual_seed(seed))
    for w, lb in draws[:60]:
        params, _ = rnn.rnn_sgd_plain(params, torch.as_tensor(w), lb, 5e-3)
    got = bc.pretrain_rnn(seed, num_states=60)
    assert all(torch.equal(got[k].view(torch.int32), params[k].view(torch.int32)) for k in params)


def test_pretraining_matches_the_reference_loop():
    """The port's pretraining (one chain of 1,200 learn steps, plain on the
    CPU) against the reference's jitted ``_rnn_sgd`` looped over the same
    windows and labels from the same weights: within the card's pretraining
    bound, the two fp32 implementations' rounding over 1,200 steps."""
    w = _ref_weights(0)
    windows, labels = bc.pretrain_windows(0)
    learn = np.ones(len(labels), bool)
    got, _ = rnn.rnn_chain(_torch(w), windows, None, labels, None, learn, ~learn, ~learn, 5e-3)
    p = {k: jnp.asarray(v) for k, v in w.items()}
    lr = jnp.asarray(5e-3)
    for x, lb in zip(windows, labels[:, 0]):
        p, _ = ref._rnn_sgd(p, jnp.asarray(x), jnp.asarray(int(lb)), lr)
    gap = _rel_gap({k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in p.items()})
    print(f"pretraining, port against reference: largest relative leaf gap {gap:.3g}")
    assert gap <= model.PRETRAIN_BOUND_FACTOR * model.PRETRAIN_FP32_GAP


# ---------------------------------------------------------------------- (d)
def test_pretraining_fp32_gap_sets_the_card_bound():
    """The plain pretraining in fp32 against the same 1,200 steps in float64
    (autograd on float64 leaves and windows), from init_rnn(seed 0): the
    largest relative leaf gap, measured here at 2.594e-6 (wh0), is what
    ``torch_rnn_model.PRETRAIN_FP32_GAP`` records; the card holds the
    kernel's pretraining to 4 times it from the plain version's."""
    p32 = bc.init_rnn(torch.Generator().manual_seed(0))
    windows, labels = bc.pretrain_windows(0)
    learn = np.ones(len(labels), bool)
    a, _ = rnn.rnn_chain(p32, windows, None, labels, None, learn, ~learn, ~learn, 5e-3)
    b = {k: v.double() for k, v in p32.items()}
    for x, lb in zip(windows.astype(np.float64), labels[:, 0]):
        b, _ = rnn.rnn_sgd_plain(b, torch.from_numpy(x), int(lb), 5e-3)
    gap = _rel_gap({k: v.numpy() for k, v in a.items()}, {k: v.numpy() for k, v in b.items()})
    print(f"pretraining fp32 against fp64: largest relative leaf gap {gap:.4g}")
    assert 0 < gap <= model.PRETRAIN_FP32_GAP


# ---------------------------------------------------------------------- (e)
def test_parent_weights_unchanged_after_the_child_learns():
    parent = bc.BroadcastPredictor(params=_torch(_ref_weights(4)), k=10, records=[0.5, 1.25, 0.75])
    before = {k: v.clone() for k, v in parent.params.items()}
    child = bc.predictor_for_expansion(parent, 2.0)
    assert child.params is parent.params
    child.observe(1.5)
    child.learn(1)
    shadow = parent.shadow()
    shadow_params, _ = bc.predictor_chain(shadow.params, bc.build_seq(parent.records, 10)[None],
                                          bc.build_seq(parent.records, 10)[None], np.ones((1, 2), np.int64),
                                          np.zeros((1, 2), bool), [True], [True], [False])
    assert all(torch.equal(parent.params[k].view(torch.int32), before[k].view(torch.int32)) for k in before)
    assert not all(torch.equal(child.params[k], before[k]) for k in before)
    assert not all(torch.equal(shadow_params[k], before[k]) for k in before)


# ------------------------------------------------------------- the wrapper
def test_kernel_path_refuses_a_window_past_its_limit():
    """A window longer than the kernel takes raises before anything is
    built or launched: there is no fallback."""
    params = _torch(_ref_weights(0))
    gates = np.array([rnn.LEARN], np.int32)
    with pytest.raises(ValueError, match="1 to 1024"):
        rnn._launch(params, np.zeros((1, rnn.MAX_T + 1), np.float32), None, np.zeros((1, 1), np.int32), None, gates,
                    LR)
    with pytest.raises(ValueError, match="0 or 1"):
        rnn._launch(params, np.zeros((1, 10), np.float32), None, np.full((1, 1), 2, np.int32), None, gates, LR)
