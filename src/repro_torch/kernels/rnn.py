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
moves where a step wants a broadcast. :func:`rnn_sgd` (one learn),
:func:`rnn_want` (one decision) and :func:`rnn_step` (a per-event upload's
learn and decision) are one-step chains. On the card each is one ctypes call
and one launch of the same kernel (``rnn_chain.launches`` counts them all):
the call hands the C entry a descriptor and the operands packed into one
host array, which it stages through reused pinned slots and copies into the
tail of the call's one device buffer. It never writes the weights it is
given: a launch with a learn step returns fresh leaves, views into that
buffer (a :class:`KernelLeaves`, which the next launch takes without
re-checking); a decision-only launch returns the weights it was given.

On the CPU (and the ``meta`` device) the plain versions run: eager
autograd, one op at a time, held bit for bit to the serial learn/decide
path and within 1e-6 to the reference by the CPU tests. The kernel's ``tanhf``,
``expf`` and ``logf`` are not the CPU's, so it is held to them by tolerance
and, bit for bit, to itself: a chain is the same steps as per-event
launches, and a launch repeats its bits.
"""
from __future__ import annotations

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
_LEAF_SIZES = [int(np.prod(s)) for s in SHAPES.values()]


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
class KernelLeaves(dict):
    """The leaves a learn launch returns: views into the one buffer it
    wrote, whose address is ``base``. A later launch given this dict with
    these very tensors skips the per-leaf checks (and the device rule): the
    kernel made them."""

    def __init__(self, leaves: dict, base: int):
        super().__init__(leaves)
        self.made = tuple(leaves.values())
        self.base = base

    def verified(self) -> bool:
        """These very leaves, still at ``base`` (a copy of the dict made by
        ``copy.deepcopy`` or a pickle holds other tensors: it is checked)."""
        return (len(self) == len(self.made) and all(a is b for a, b in zip(self.values(), self.made))
                and self.made[0].data_ptr() == self.base)


class _Launch:
    """A launch's results in its one output buffer ``out``: the final
    leaves (fresh where a step learns, else the given ones), then each
    step's loss and decision, as views made when asked."""

    __slots__ = ("params", "out", "at", "S")

    def __init__(self, params: dict, out: torch.Tensor, at: int, S: int):
        self.params, self.out, self.at, self.S = params, out, at, S

    @property
    def losses(self) -> torch.Tensor:  # (S,) fp32
        return self.out[self.at:self.at + 4 * self.S].view(torch.float32)

    @property
    def wants(self) -> torch.Tensor:  # (S,) bool
        return self.out[self.at + 4 * self.S:self.at + 5 * self.S].view(torch.bool)

    def want(self, i: int) -> torch.Tensor:  # step i's decision, a 0-d bool
        return self.out[self.at + 4 * self.S + i].view(torch.bool)


_PLANS: dict[tuple[int, int], dict] = {}
_LEAF_BYTES = 4 * np.cumsum([0] + _LEAF_SIZES[:-1]).astype(np.int64)  # each leaf's offset in a flat buffer
_MATRICES = [name for name, shape in SHAPES.items() if len(shape) == 2]


def plan(T: int, device: int | None = None) -> dict:
    """The launch at window length T on ``device`` (default: the current
    card), by the variant the window length takes (csrc/rnn.cu `variant`:
    one block to T = 104, a cluster of two past it): ``smem`` (dynamic
    shared memory bytes a block), ``scratch`` (floats of global scratch for
    the histories; 0 where they fit in shared memory), ``threads`` a block,
    ``cluster`` blocks, and the kernel's ``registers`` and spilled
    ``local_bytes`` a thread."""
    dev = torch.cuda.current_device() if device is None else device
    key = (T, dev)
    if key not in _PLANS:
        out = np.zeros(6, np.int64)
        _build.check(_build.library().repro_rnn_chain_plan(T, dev, out.ctypes.data), "rnn_chain plan")
        _PLANS[key] = dict(zip(("smem", "scratch", "threads", "cluster", "registers", "local_bytes"),
                               map(int, out)))
    return _PLANS[key]


def _window(seq) -> np.ndarray:
    """A (T, 1) or (T,) window as fp32 numpy (a tensor on the card is read back: a host sync)."""
    if isinstance(seq, torch.Tensor):
        seq = seq.detach().cpu().numpy()
    return np.asarray(seq, np.float32).reshape(-1)


def _check_leaves(params: dict) -> None:
    if set(params) != set(SHAPES):
        raise ValueError(f"rnn_chain: params must hold the leaves {sorted(SHAPES)}, got {sorted(params)}")
    for name, shape in SHAPES.items():
        v = params[name]
        if v.dtype != torch.float32 or tuple(v.shape) != shape or not v.is_contiguous():
            raise ValueError(f"rnn_chain kernel: {name} must be a contiguous float32 {shape}, got {v.dtype} "
                             f"{tuple(v.shape)}")


def _launch(params: dict, pre, post, lab, fb, gates: np.ndarray, lr: float) -> _Launch:
    """One kernel launch over S = len(gates) steps. ``pre``/``post`` (S, T)
    fp32 or None, ``lab``/``fb`` (S, cols) ints or None. The operands are
    packed into one host array (fp32 windows, then int32 tables and gates),
    which the C entry stages through its pinned slots and copies, on the
    launch's stream, into the tail of the call's one device buffer: the
    final weights (where a step learns), the losses, the wants, the
    operands."""
    ours = isinstance(params, KernelLeaves) and params.verified()
    if not ours:
        _check_leaves(params)
    S = len(gates)
    T = (pre if pre is not None else post).shape[1]
    if S == 0 or not 1 <= T <= MAX_T:
        raise ValueError(f"rnn_chain kernel: needs S >= 1 steps and a window of 1 to {MAX_T} records, got S {S}, "
                         f"T {T}")
    cols = lab.shape[1]
    learns = bool(np.any(gates & LEARN))
    if lab.shape[0] != S or cols < (S if np.any(gates & (DECIDE | FALLBACK)) else 1):
        raise ValueError(f"rnn_chain kernel: label table {lab.shape} for {S} steps")
    if np.any((lab != 0) & (lab != 1)):
        raise ValueError("rnn_chain kernel: labels must be 0 or 1")
    parts = (pre, post, lab, fb, gates)
    host = np.empty(sum(0 if a is None else a.size for a in parts), np.int32)
    o, offs = 0, []
    for a in parts:
        if a is None:
            offs.append(-1)
            continue
        offs.append(o)
        n = a.size
        if a.dtype == np.float32:
            host[o:o + n].view(np.float32)[:] = a.reshape(-1)
        else:
            host[o:o + n] = a.reshape(-1)
        o += n
    dev = params["wh0"].device
    w = 4 * LEAF_FLOATS if learns else 0
    ops_at = w + 4 * S + (-S % 4 + S)  # the losses, then the wants padded to 4 bytes
    out = torch.empty(ops_at + 4 * host.size, dtype=torch.uint8, device=dev)
    base = out.data_ptr()
    need = plan(T, dev.index)["scratch"]
    scratch = torch.empty(need, dtype=torch.float32, device=dev) if need else None
    desc = np.empty(24, np.int64)  # csrc/rnn.cu RnnDesc
    desc[:8] = params.base + _LEAF_BYTES if ours else [params[name].data_ptr() for name in SHAPES]
    desc[8:] = (base if w else 0, base + w, base + w + 4 * S, 0 if scratch is None else scratch.data_ptr(),
                base + ops_at, 4 * host.size, *offs, S, T, cols, int(np.float32(lr).view(np.uint32)),
                dev.index)
    _build.check(_build.library().repro_rnn_chain(desc.ctypes.data, host.ctypes.data, _build.stream(out)),
                 "rnn_chain")
    rnn_chain.launches += 1
    new = params
    if w:
        leaves = dict(zip(SHAPES, out[:w].view(torch.float32).split(_LEAF_SIZES)))
        for name in _MATRICES:
            leaves[name] = leaves[name].view(SHAPES[name])
        new = KernelLeaves(leaves, base)
    return _Launch(new, out, w, S)


def _plain_here(what: str, params: dict) -> bool:
    """The plain version for CPU and ``meta`` leaves, the kernel for leaves
    on one card (a dict of leaves the kernel made needs no look)."""
    return not (isinstance(params, KernelLeaves) and params.verified()) and use_plain(what, *params.values())


def _as_tensor(seq, dev) -> torch.Tensor:
    return seq if isinstance(seq, torch.Tensor) else torch.from_numpy(np.asarray(seq, np.float32)).to(dev)


def rnn_sgd(params: dict, seq, label: int | torch.Tensor, lr: float) -> tuple[dict, torch.Tensor]:
    """One SGD step on -log softmax(logits(seq))[label] -> (fresh params, the
    loss as a device scalar). ``seq`` (T, 1): a numpy array or a tensor."""
    if _plain_here("rnn_sgd", params):
        return rnn_sgd_plain(params, _as_tensor(seq, params["wh0"].device), label, lr)
    label = int(label)
    out = _launch(params, _window(seq)[None], None, np.array([[label]], np.int32), None,
                  np.array([LEARN], np.int32), lr)
    return out.params, out.losses[0]


def rnn_want(params: dict, seq) -> torch.Tensor:
    """The broadcast decision on ``seq`` (T, 1): ``argmax(logits) == 1`` as a device bool."""
    if _plain_here("rnn_want", params):
        return rnn_want_plain(params, _as_tensor(seq, params["wh0"].device))
    out = _launch(params, None, _window(seq)[None], np.zeros((1, 1), np.int32), None,
                  np.array([DECIDE], np.int32), 0.0)
    return out.want(0)


def rnn_step(params: dict, pre, post, label: int | None, lr: float) -> tuple[dict, torch.Tensor | None]:
    """One upload's predictor work: the SGD step on ``pre`` (the window
    before observe) toward ``label`` where ``label`` is not None, then the
    decision on ``post`` (the window after it) where ``post`` is not None ->
    (params, want as a device bool or None). The same bits as
    :func:`rnn_sgd` then :func:`rnn_want`, in one launch on the card."""
    learn, decide = label is not None, post is not None
    if _plain_here("rnn_step", params):
        dev = params["wh0"].device
        return rnn_chain_step(params, _as_tensor(pre, dev) if learn else None,
                              _as_tensor(post, dev) if decide else None, int(label) if learn else None,
                              learn, decide, lr)
    lab = np.array([[int(label)] * 2 if learn else [0, 0]], np.int32)
    out = _launch(params, _window(pre)[None] if learn else None, _window(post)[None] if decide else None, lab,
                  None, np.array([LEARN * learn | DECIDE * decide], np.int32), lr)
    return out.params, out.want(0) if decide else None


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
    if _plain_here("rnn_chain", params):
        return rnn_chain_plain(params, pre, post, lab_table, fb_table, learn_gate, decide_gate, fb_gate, lr)
    S = len(learn_gate)
    gates = (learn_gate * LEARN | (decide_gate & ~fb_gate) * DECIDE | fb_gate * FALLBACK).astype(np.int32)

    def flat(a, dtype):
        return np.asarray(a, dtype).reshape(S, -1)

    out = _launch(params, flat(pre, np.float32), flat(post, np.float32) if decide_gate.any() else None,
                  flat(lab_table, np.int32), flat(fb_table, np.int32) if fb_gate.any() else None, gates, lr)
    return out.params, out.wants


rnn_chain.launches = 0
