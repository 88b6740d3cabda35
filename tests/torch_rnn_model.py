"""A numpy model of the broadcast RNN kernel (``csrc/rnn.cu``).

It follows the kernel's hand-written arithmetic step by step: the forward
over the window, the output layer's softmax gradient, backpropagation
through time over both layers, the update without a gradient buffer (each
weight's gradient a sum over t in descending order) and the chain's gates
and fired position. In float64 it is the exact reference the CPU tests hold
autograd and ``jax.grad`` to; in float32 it shows that the derivation
holds at the kernel's precision. It models the algorithm, not the kernel's
bits: ``tanhf``, ``expf`` and ``logf`` on the card are not numpy's.

Imports no JAX: the card tests use it too.
"""
import numpy as np

HIDDEN = 128
LEAVES = ("wx0", "wh0", "b0", "wx1", "wh1", "b1", "w_out", "b_out")

# The pretraining's card bound (tests/test_torch_rnn_kernel.py, test (d)): the largest leaf gap,
# max |w32 - w64| / max |w64| over the leaves, between the plain pretraining (1,200 SGD steps at
# lr 5e-3 from init_rnn(seed 0)) in fp32 and the same steps in float64 was 2.594e-6 on the CPU
# (2.866e-6 from seed 1). The kernel's pretraining may be 4 times that from the plain version's: two
# fp32 runs that each stay within about one such gap of the exact one differ by about two, and the
# card's tanhf, expf and logf round otherwise than the CPU's.
PRETRAIN_FP32_GAP = 2.6e-6
PRETRAIN_BOUND_FACTOR = 4.0


def forward(params: dict, x: np.ndarray, dtype=np.float64):
    """x (T,) -> (H0 (T, 128), H1 (T, 128), logits (2,))."""
    p = {k: np.asarray(v, dtype) for k, v in params.items()}
    x = np.asarray(x, dtype).reshape(-1)
    T = x.shape[0]
    H0 = np.zeros((T, HIDDEN), dtype)
    H1 = np.zeros((T, HIDDEN), dtype)
    h0 = np.zeros(HIDDEN, dtype)
    h1 = np.zeros(HIDDEN, dtype)
    for t in range(T):
        h0 = np.tanh(x[t] * p["wx0"][0] + h0 @ p["wh0"] + p["b0"])
        h1 = np.tanh(h0 @ p["wx1"] + h1 @ p["wh1"] + p["b1"])
        H0[t], H1[t] = h0, h1
    return H0, H1, h1 @ p["w_out"] + p["b_out"]


def grads(params: dict, x: np.ndarray, label: int, dtype=np.float64):
    """The hand-written backward: (gradient of every leaf, loss)."""
    p = {k: np.asarray(v, dtype) for k, v in params.items()}
    x = np.asarray(x, dtype).reshape(-1)
    T = x.shape[0]
    H0, H1, lg = forward(p, x, dtype)
    m = max(lg[0], lg[1])
    lse = np.log(np.exp(lg[0] - m) + np.exp(lg[1] - m))
    logp = (lg - m) - lse
    dl = np.exp(logp) - np.eye(2, dtype=dtype)[label]
    D0 = np.zeros((T, HIDDEN), dtype)
    D1 = np.zeros((T, HIDDEN), dtype)
    D1[T - 1] = (p["w_out"] @ dl) * (1 - H1[T - 1] * H1[T - 1])
    zero = np.zeros(HIDDEN, dtype)
    for t in range(T - 1, -1, -1):  # one backward pass of the kernel
        d0_next = D0[t + 1] if t + 1 < T else zero
        if t >= 1:
            D1[t - 1] = (p["wh1"] @ D1[t]) * (1 - H1[t - 1] * H1[t - 1])
        D0[t] = (p["wx1"] @ D1[t] + p["wh0"] @ d0_next) * (1 - H0[t] * H0[t])
    g = {k: np.zeros_like(v) for k, v in p.items()}
    for t in range(T - 1, -1, -1):  # each sum over t in descending order
        if t >= 1:
            g["wh0"] += np.outer(H0[t - 1], D0[t])
            g["wh1"] += np.outer(H1[t - 1], D1[t])
        g["wx1"] += np.outer(H0[t], D1[t])
        g["wx0"][0] += x[t] * D0[t]
        g["b0"] += D0[t]
        g["b1"] += D1[t]
    g["w_out"] = np.outer(H1[T - 1], dl)
    g["b_out"] = dl.copy()
    return g, -logp[label]


def sgd(params: dict, x: np.ndarray, label: int, lr: float, dtype=np.float64):
    """One SGD step: (new params, loss)."""
    g, loss = grads(params, x, label, dtype)
    return {k: np.asarray(params[k], dtype) - dtype(lr) * g[k] for k in LEAVES}, loss


def chain(params: dict, pre, post, lab, fb, learn, decide, fallback, lr: float, dtype=np.float64):
    """The kernel's step loop -> (final params, wants, margins): each
    decision's logit margin l1 - l0 (NaN where the step took no RNN
    decision)."""
    p = {k: np.asarray(params[k], dtype) for k in LEAVES}
    fire, wants, margins = 0, [], []
    for s in range(len(learn)):
        if learn[s]:
            p, _ = sgd(p, pre[s], int(lab[s][fire]), lr, dtype)
        want, margin = False, np.nan
        if fallback[s]:
            want = bool(fb[s][fire])
        elif decide[s]:
            lg = forward(p, post[s], dtype)[2]
            margin = float(lg[1] - lg[0])
            want = bool(lg[1] > lg[0])
        if want:
            fire = s + 1
        wants.append(want)
        margins.append(margin)
    return p, wants, margins


# ------------------------------------------------ the card's checks (no JAX)
DECISION_MARGIN = 1e-5  # kernel and plain decisions must agree where the plain logit margin exceeds this


def chain_inputs(k: int, steps: int, seed: int):
    """A chain's operands, drawn as ``tests/test_torch_predictor_chain.py``
    draws them: record windows before/after each step's observe at length k
    (ragged: the records start shorter than k, zero front-padded), random
    gates (a fallback step decides from its table, not the RNN), and label
    and fallback tables whose columns differ, so the fired position matters."""
    from repro_torch.core.broadcast import build_seq

    rng = np.random.default_rng(seed * 101 + k)
    records = [float(x) for x in rng.uniform(0.1, 3.0, rng.integers(1, k + 1))]
    pre = np.zeros((steps, k, 1), np.float32)
    post = np.zeros((steps, k, 1), np.float32)
    for p in range(steps):
        pre[p] = build_seq(records, k)
        records = (records + [float(rng.uniform(0.1, 3.0))])[-k:]
        post[p] = build_seq(records, k)
    learn = rng.uniform(size=steps) < 0.7
    kind = rng.integers(0, 4, steps)  # 0 idle, 1 RNN decision, 2 fallback, 3 RNN decision
    decide, fallback = (kind == 1) | (kind == 3), kind == 2
    lab = rng.integers(0, 2, (steps, steps + 1)).astype(np.int64)
    fb = rng.uniform(size=(steps, steps + 1)) < 0.5
    return pre, post, lab, fb, learn, decide, fallback


def plain_serial(params: dict, pre, post, lab, fb, learn, decide, fallback, lr: float):
    """The plain version step by step on the weights' device, the fired
    position tracked on the host -> (final params, wants, margins): each RNN
    decision's plain logit margin l1 - l0 (NaN at other steps)."""
    import torch

    from repro_torch.kernels import rnn

    dev = params["wh0"].device
    fire, wants, margins = 0, [], []
    for s in range(len(learn)):
        if learn[s]:
            params, _ = rnn.rnn_sgd_plain(params, torch.from_numpy(np.asarray(pre[s], np.float32)).to(dev),
                                          int(lab[s][fire]), lr)
        want, margin = False, np.nan
        if fallback[s]:
            want = bool(fb[s][fire])
        elif decide[s]:
            lg = rnn.rnn_logits(params, torch.from_numpy(np.asarray(post[s], np.float32)).to(dev))
            margin = float(lg[1] - lg[0])
            want = bool(torch.argmax(lg) == 1)
        if want:
            fire = s + 1
        wants.append(want)
        margins.append(margin)
    return params, wants, margins


def check_wants(got: list, want: list, margins: list, tol: float = DECISION_MARGIN) -> tuple[int, int | None]:
    """The margin rule: the kernel's wants equal the plain version's at every
    step up to the first RNN decision whose plain logit margin is within
    ``tol`` (where either answer is right; later steps then follow other
    labels). Returns (decisions within the margin, the step where the two
    first differ there, or None)."""
    under = 0
    for s, (a, b, m) in enumerate(zip(got, want, margins)):
        close = not np.isnan(m) and abs(m) <= tol
        under += close
        if a != b:
            assert close, f"step {s}: kernel want {a}, plain {b}, plain logit margin {m:.3g} > {tol}"
            return under, s
    return under, None
