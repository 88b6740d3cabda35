"""The broadcast predictor's RNN (paper Sec. 5), kernel in ``csrc/rnn.cu``.

Not a ``pallas_call``: it replaces the reference's jitted bodies of the
predictor's device work, ``src/repro/kernels/ops.py:541``
``_predictor_chain_jit`` (a ``lax.scan`` of ``rnn_chain_step``),
``src/repro/core/broadcast.py:71`` ``_rnn_sgd``, ``:81`` ``_rnn_want`` and
the per-window ``_rnn_sgd`` loop of ``pretrain_rnn`` (``:258``).

:func:`rnn_chain` runs S predictor steps of one cluster in order: at each, a
gated SGD step on the pre-observe window, then a gated decision on the
post-observe window (or the cold-start fallback decision from its table),
the label and fallback decision gathered by the last fired position, which
moves where a step wants a broadcast. :func:`rnn_sgd` (one learn) and
:func:`rnn_want` (one decision) are one-step chains. On the card each is
one ctypes call and one launch of the same kernel (``rnn_chain.launches``
counts them all), its operands packed into one host buffer and copied once;
it never writes the weights it is given: a launch with a learn step returns
fresh leaves, views into one new buffer. A decision-only launch returns the
weights it was given.

On the CPU (and the ``meta`` device) the plain versions run: eager
autograd, one op at a time, held bit for bit to the serial learn/decide
path and within 1e-6 to the reference by the CPU tests. The kernel's ``tanhf``,
``expf`` and ``logf`` are not the CPU's, so it is held to them by tolerance
and, bit for bit, to itself: a chain is the same steps as per-event
launches, and a launch repeats its bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.device import to_device
from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import use_plain

HIDDEN = 128
NUM_LAYERS = 2
MAX_T = 1024  # kMaxT in csrc/rnn.cu: the longest record window a launch takes
# the leaves, in init_rnn's order and the kernel's flat buffer's
SHAPES = {"wx0": (1, HIDDEN), "wh0": (HIDDEN, HIDDEN), "b0": (HIDDEN,), "wx1": (HIDDEN, HIDDEN),
          "wh1": (HIDDEN, HIDDEN), "b1": (HIDDEN,), "w_out": (HIDDEN, 2), "b_out": (2,)}
LEAF_FLOATS = sum(int(np.prod(s)) for s in SHAPES.values())  # 49,794
LEARN, DECIDE, FALLBACK = 1, 2, 4  # a step's gate bits


# ------------------------------------------------------------ plain versions
def rnn_logits(params: dict, seq: torch.Tensor) -> torch.Tensor:
    """seq: (T, 1) normalized change records -> (2,) logits."""
    x = seq
    h = None
    for layer in range(NUM_LAYERS):
        wx, wh, b = params[f"wx{layer}"], params[f"wh{layer}"], params[f"b{layer}"]
        h = torch.zeros(wh.shape[0], dtype=seq.dtype, device=seq.device)
        hs = []
        for t in range(x.shape[0]):
            h = torch.tanh(x[t] @ wx + h @ wh + b)
            hs.append(h)
        x = torch.stack(hs)
    return h @ params["w_out"] + params["b_out"]


def rnn_sgd_plain(params: dict, seq: torch.Tensor, label: int | torch.Tensor, lr: float) -> tuple[dict, torch.Tensor]:
    """One SGD step on -log softmax(logits)[label]; returns fresh params.
    ``label`` is an int or a (1,) int64 device tensor (read without a host
    sync); both give the same gradient bits."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        logp = torch.log_softmax(rnn_logits(leaves, seq), dim=-1)
        loss = -(logp[label] if isinstance(label, int) else logp.index_select(0, label)[0])
        grads = torch.autograd.grad(loss, list(leaves.values()))
    new = {k: (v - lr * g).detach() for (k, v), g in zip(leaves.items(), grads)}
    return new, loss.detach()


def rnn_want_plain(params: dict, seq: torch.Tensor) -> torch.Tensor:
    """Forward + first-index argmax decision (a device bool)."""
    return torch.argmax(rnn_logits(params, seq)) == 1


def rnn_chain_step(params: dict, pre: torch.Tensor, post: torch.Tensor | None, label: torch.Tensor,
                   learn_gate: bool, decide_gate: bool, lr: float) -> tuple[dict, torch.Tensor | None]:
    """One upload's predictor work in a coalesced window (the step of
    :func:`rnn_chain_plain`): the SGD step on the pre-observe window when
    ``learn_gate``, then the broadcast decision on the post-observe window
    when ``decide_gate`` (a device bool, else None). The gates are host
    booleans, so a skipped body costs nothing; ``label`` is a (1,) device
    tensor. The same arithmetic as a serial ``BroadcastPredictor.learn``
    then ``BroadcastPredictor.decide``."""
    if learn_gate:
        params, _ = rnn_sgd_plain(params, pre, label, lr)
    return params, (rnn_want_plain(params, post) if decide_gate else None)


def rnn_chain_plain(params: dict, pre, post, lab_table, fb_table, learn_gate, decide_gate, fb_gate,
                    lr: float) -> tuple[dict, torch.Tensor]:
    """:func:`rnn_chain` in plain PyTorch, with no host sync: the chain
    carries the weights and the fired position ``fire`` as a device int,
    gathers each step's label and fallback decision from the tables on the
    device, and moves ``fire`` where a step wants a broadcast. ``post`` and
    ``fb_table`` may be None where no step decides or falls back."""
    dev = next(iter(params.values())).device
    pre_d = to_device(np.asarray(pre, np.float32), dev)
    post_d = None if post is None else to_device(np.asarray(post, np.float32), dev)
    lab_d = to_device(np.asarray(lab_table, np.int64), dev)
    fb_d = None if fb_table is None else to_device(np.asarray(fb_table, np.bool_), dev)
    fire = torch.zeros(1, dtype=torch.long, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    wants = []
    for p in range(len(learn_gate)):
        params, want = rnn_chain_step(params, pre_d[p], None if post_d is None else post_d[p],
                                      lab_d[p].index_select(0, fire), bool(learn_gate[p]), bool(decide_gate[p]), lr)
        if fb_gate[p]:
            want = fb_d[p].index_select(0, fire)[0]
        elif want is None:
            want = no
        fire = torch.where(want, p + 1, fire)
        wants.append(want)
    return params, torch.stack(wants)


# ---------------------------------------------------------------- the kernel
@dataclasses.dataclass
class _Launch:
    params: dict  # fresh leaves (views into one buffer), or the given ones where no step learns
    losses: torch.Tensor  # (S,) each learn step's loss
    wants: torch.Tensor  # (S,) bool


_PLANS: dict[int, tuple[int, int]] = {}


def plan(T: int) -> dict:
    """The launch at window length T: ``smem`` (dynamic shared memory bytes)
    and ``scratch`` (floats of global scratch for the histories; 0 where
    they fit in shared memory)."""
    if T not in _PLANS:
        out = np.zeros(2, np.int64)
        _build.check(_build.library().repro_rnn_chain_plan(T, out.ctypes.data), "rnn_chain plan")
        _PLANS[T] = (int(out[0]), int(out[1]))
    smem, scratch = _PLANS[T]
    return {"smem": smem, "scratch": scratch}


def _window(seq) -> np.ndarray:
    """A (T, 1) or (T,) window as fp32 numpy (a tensor on the card is read back: a host sync)."""
    if isinstance(seq, torch.Tensor):
        seq = seq.detach().cpu().numpy()
    return np.asarray(seq, np.float32).reshape(-1)


def _launch(params: dict, pre, post, lab, fb, gates: np.ndarray, lr: float) -> _Launch:
    """One kernel launch over S = len(gates) steps. ``pre``/``post`` (S, T)
    fp32 or None, ``lab``/``fb`` (S, cols) ints or None. The operands go to
    the card in one packed buffer (fp32 windows, then int32 tables and
    gates) and one copy."""
    if set(params) != set(SHAPES):
        raise ValueError(f"rnn_chain: params must hold the leaves {sorted(SHAPES)}, got {sorted(params)}")
    for name, shape in SHAPES.items():
        v = params[name]
        if v.dtype != torch.float32 or tuple(v.shape) != shape or not v.is_contiguous():
            raise ValueError(f"rnn_chain kernel: {name} must be a contiguous float32 {shape}, got {v.dtype} "
                             f"{tuple(v.shape)}")
    S = len(gates)
    T = (pre if pre is not None else post).shape[1]
    if S == 0 or not 1 <= T <= MAX_T:
        raise ValueError(f"rnn_chain kernel: needs S >= 1 steps and a window of 1 to {MAX_T} records, got S {S}, "
                         f"T {T}")
    cols = lab.shape[1]
    decides = bool(np.any(gates & (DECIDE | FALLBACK)))
    if lab.shape[0] != S or cols < (S if decides else 1):
        raise ValueError(f"rnn_chain kernel: label table {lab.shape} for {S} steps")
    if np.any((lab != 0) & (lab != 1)):
        raise ValueError("rnn_chain kernel: labels must be 0 or 1")
    parts = [pre, post, lab, fb, gates]
    sizes = [0 if a is None else a.size for a in parts]
    host = np.empty(sum(sizes), np.int32)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    for a, o, n in zip(parts, offs, sizes):
        if a is not None:
            if a.dtype == np.float32:
                host[o:o + n].view(np.float32)[:] = a.reshape(-1)
            else:
                host[o:o + n] = a.reshape(-1)
    dev = params["wh0"].device
    buf = to_device(host, dev)
    ptr = [None if a is None else buf.data_ptr() + 4 * int(o) for a, o in zip(parts, offs)]
    # one output buffer: the final weights (only where a step learns), the losses, the wants
    w = 4 * LEAF_FLOATS if np.any(gates & LEARN) else 0
    out = torch.empty(w + 5 * S, dtype=torch.uint8, device=dev)
    need = plan(T)["scratch"]
    scratch = torch.empty(need, dtype=torch.float32, device=dev) if need else None
    rc = _build.library().repro_rnn_chain(
        *(params[name].data_ptr() for name in SHAPES), *ptr, out.data_ptr() if w else None, out.data_ptr() + w,
        out.data_ptr() + w + 4 * S, None if scratch is None else scratch.data_ptr(), S, T, cols, float(lr),
        dev.index or 0, _build.stream(out),
    )
    _build.check(rc, "rnn_chain")
    rnn_chain.launches += 1
    new = params
    if w:
        flat, new, o = out[:w].view(torch.float32), {}, 0
        for name, shape in SHAPES.items():
            n = int(np.prod(shape))
            new[name] = flat[o:o + n].view(shape)
            o += n
    return _Launch(params=new, losses=out[w:w + 4 * S].view(torch.float32), wants=out[w + 4 * S:].view(torch.bool))


def rnn_sgd(params: dict, seq, label: int | torch.Tensor, lr: float) -> tuple[dict, torch.Tensor]:
    """One SGD step on -log softmax(logits(seq))[label] -> (fresh params, the
    loss as a device scalar). ``seq`` (T, 1): a numpy array or a tensor."""
    if use_plain("rnn_sgd", *params.values()):
        dev = params["wh0"].device
        seq_t = seq if isinstance(seq, torch.Tensor) else torch.from_numpy(np.asarray(seq, np.float32)).to(dev)
        return rnn_sgd_plain(params, seq_t, label, lr)
    label = int(label)
    out = _launch(params, _window(seq)[None], None, np.array([[label]], np.int32), None,
                  np.array([LEARN], np.int32), lr)
    return out.params, out.losses[0]


def rnn_want(params: dict, seq) -> torch.Tensor:
    """The broadcast decision on ``seq`` (T, 1): ``argmax(logits) == 1`` as a device bool."""
    if use_plain("rnn_want", *params.values()):
        dev = params["wh0"].device
        seq_t = seq if isinstance(seq, torch.Tensor) else torch.from_numpy(np.asarray(seq, np.float32)).to(dev)
        return rnn_want_plain(params, seq_t)
    out = _launch(params, None, _window(seq)[None], np.zeros((1, 1), np.int32), None,
                  np.array([DECIDE], np.int32), 0.0)
    return out.wants[0]


def rnn_chain(params: dict, pre, post, lab_table, fb_table, learn_gate, decide_gate, fb_gate,
              lr: float) -> tuple[dict, torch.Tensor]:
    """S predictor steps of one cluster -> (final params, wants (S,) device
    bools). ``pre``/``post`` (S, k, 1) record windows before and after each
    step's observe (``post`` may be None where no step decides),
    ``lab_table`` (S, C) ints and ``fb_table`` (S, C) bools (None where no
    step falls back) each step's Eq. 4 label and cold-start decision for
    every last fired position (column 0 the window-start anchor, column q +
    1 step q fired last; C = 1 where nothing decides), and the three gates
    (S,) host booleans. One launch on the card."""
    learn_gate, decide_gate, fb_gate = (np.asarray(g, bool) for g in (learn_gate, decide_gate, fb_gate))
    if use_plain("rnn_chain", *params.values()):
        return rnn_chain_plain(params, pre, post, lab_table, fb_table, learn_gate, decide_gate, fb_gate, lr)
    S = len(learn_gate)
    gates = (learn_gate * LEARN | (decide_gate & ~fb_gate) * DECIDE | fb_gate * FALLBACK).astype(np.int32)

    def flat(a, dtype):
        return np.asarray(a, dtype).reshape(S, -1)

    out = _launch(params, flat(pre, np.float32), flat(post, np.float32) if decide_gate.any() else None,
                  flat(lab_table, np.int32), flat(fb_table, np.int32) if fb_gate.any() else None, gates, lr)
    return out.params, out.wants


rnn_chain.launches = 0
