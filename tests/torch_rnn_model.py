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


# ------------------------------------------- the kernel's sums (csrc/rnn.cu)
# A thread holds rows 32 r + 8 g + a (a < 8) and columns 32 c + 4 q + b (b < 4) of each matrix: row tile
# r, row group g, column tile c, column group q (csrc/rnn.cu's kRowsT, kColsT, kRowGroups, kColGroups).
TILE, TILES, ROWS_T, COLS_T, ROW_GROUPS, COL_GROUPS = 32, 4, 8, 4, 4, 8
# The model's gradients in float32 are held to autograd's and jax.grad's at rtol GRAD_RTOL plus an atol
# of GRAD_ATOL_OF_MAX times a leaf's largest |gradient| (tests/test_torch_rnn_kernel.py's bounds).
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-5, 2e-6


def _fma(a, b, c) -> np.ndarray:
    """fmaf on float32 arrays: the product is exact in float64 and the sum
    rounded there, then to float32 (a double rounding the card's fmaf does
    not make, at most one float32 ulp in rare cases: the model is held by
    tolerance)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def kernel_hw(h: np.ndarray, W: np.ndarray) -> np.ndarray:
    """h @ W in the kernel's forward order: each thread's fmaf chain over its
    8 rows, the warp's reduce-scatter (S0 + S2) + (S1 + S3) over its row
    groups, then the row tiles ((r0 + r1) + r2) + r3."""
    hr = np.asarray(h, np.float32).reshape(TILES, ROW_GROUPS, ROWS_T)
    Wr = np.asarray(W, np.float32).reshape(TILES, ROW_GROUPS, ROWS_T, HIDDEN)
    acc = np.zeros((TILES, ROW_GROUPS, HIDDEN), np.float32)
    for a in range(ROWS_T):
        acc = _fma(hr[:, :, a, None], Wr[:, :, a], acc)
    warp = (acc[:, 0] + acc[:, 2]) + (acc[:, 1] + acc[:, 3])
    return ((warp[0] + warp[1]) + warp[2]) + warp[3]


def kernel_wd(W: np.ndarray, d: np.ndarray) -> np.ndarray:
    """W @ d in the kernel's backward order: each thread's fmaf chain over its
    4 columns, the warp's reduce-scatter over its 8 column groups,
    ((C0 + C4) + (C2 + C6)) + ((C1 + C5) + (C3 + C7)), then the column tiles
    in order."""
    Wc = np.asarray(W, np.float32).reshape(HIDDEN, TILES, COL_GROUPS, COLS_T)
    dc = np.asarray(d, np.float32).reshape(TILES, COL_GROUPS, COLS_T)
    acc = np.zeros((HIDDEN, TILES, COL_GROUPS), np.float32)
    for b in range(COLS_T):
        acc = _fma(Wc[..., b], dc[None, :, :, b], acc)
    C = [acc[..., q] for q in range(COL_GROUPS)]
    warp = ((C[0] + C[4]) + (C[2] + C[6])) + ((C[1] + C[5]) + (C[3] + C[7]))
    return ((warp[:, 0] + warp[:, 1]) + warp[:, 2]) + warp[:, 3]


def butterfly(v: np.ndarray) -> np.float32:
    """A warp's sum of 32 lanes by shuffles xor 16, 8, 4, 2, 1 (every lane ends with these bits)."""
    v = np.asarray(v, np.float32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[np.arange(32) ^ o]
    return v[0]


def kernel_grads(params: dict, x: np.ndarray, label: int):
    """The gradient of every leaf and the loss as csrc/rnn.cu sums them, in
    float32: the forward and backward passes in the orders of
    :func:`kernel_hw` and :func:`kernel_wd`, the logits a lane's fmaf chain
    over rows l, l + 32, l + 64, l + 96 then :func:`butterfly`, and each
    weight's gradient an fmaf chain over t in descending order. numpy's
    tanh, exp and log stand for the card's."""
    f32 = np.float32
    p = {k: np.asarray(v, f32) for k, v in params.items()}
    x = np.asarray(x, f32).reshape(-1)
    T = x.shape[0]
    H0, H1 = np.zeros((T, HIDDEN), f32), np.zeros((T, HIDDEN), f32)
    h1 = np.zeros(HIDDEN, f32)
    for t in range(T):
        s0 = kernel_hw(H0[t - 1], p["wh0"]) if t else np.zeros(HIDDEN, f32)
        H0[t] = np.tanh((x[t] * p["wx0"][0] + s0) + p["b0"])
        H1[t] = h1 = np.tanh((kernel_hw(H0[t], p["wx1"]) + kernel_hw(h1, p["wh1"])) + p["b1"])
    lanes = np.zeros((2, 32), f32)
    for m in range(TILES):
        lanes = _fma(h1[m * TILE:(m + 1) * TILE], p["w_out"][m * TILE:(m + 1) * TILE].T, lanes)
    lg = np.array([butterfly(lanes[0]), butterfly(lanes[1])], f32) + p["b_out"]
    m = max(lg[0], lg[1])
    lse = f32(np.log(np.exp(lg[0] - m) + np.exp(lg[1] - m)))
    logp = (lg - m) - lse
    dl = np.exp(logp) - np.eye(2, dtype=f32)[label]
    D0, D1 = np.zeros((T, HIDDEN), f32), np.zeros((T, HIDDEN), f32)
    D1[T - 1] = (p["w_out"][:, 0] * dl[0] + p["w_out"][:, 1] * dl[1]) * (1 - H1[T - 1] * H1[T - 1])
    for t in range(T - 1, -1, -1):
        if t >= 1:
            D1[t - 1] = kernel_wd(p["wh1"], D1[t]) * (1 - H1[t - 1] * H1[t - 1])
        r0 = kernel_wd(p["wh0"], D0[t + 1]) if t + 1 < T else np.zeros(HIDDEN, f32)
        D0[t] = (kernel_wd(p["wx1"], D1[t]) + r0) * (1 - H0[t] * H0[t])
    g = {k: np.zeros_like(v) for k, v in p.items()}
    for t in range(T - 1, -1, -1):
        if t >= 1:
            g["wh0"] = _fma(H0[t - 1][:, None], D0[t][None], g["wh0"])
            g["wh1"] = _fma(H1[t - 1][:, None], D1[t][None], g["wh1"])
        g["wx1"] = _fma(H0[t][:, None], D1[t][None], g["wx1"])
        g["wx0"][0] = _fma(x[t], D0[t], g["wx0"][0])
        g["b0"] = g["b0"] + D0[t]
        g["b1"] = g["b1"] + D1[t]
    g["w_out"] = H1[T - 1][:, None] * dl[None]
    g["b_out"] = dl
    return g, -logp[label]


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
