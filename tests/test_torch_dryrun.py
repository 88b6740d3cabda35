"""The port's dry-run (``launch/dryrun.py``) and its cost model
(``launch/cost.py``) against the reference's ``launch/dryrun.py`` and
``launch/hlo_cost.py``.

All eleven archs at full size: ``params``, ``active_params`` and
``model_flops`` equal the reference's ``specs.model_param_count`` /
``model_active_param_count`` and its ``6 N_active`` rule exactly.

Reduced llama3.2-1b and granite-moe-3b-a800m, batch 4 x 64 tokens, train,
prefill and decode, unmeshed (1 x 1) and on a (2, 4) mesh, at bf16: the
reference lowers and compiles each cell in one child interpreter on a
forced 8-device host with ``Auto`` axes (its meshes' default explicit axes
raise on jax 0.9.0) and costs it with ``hlo_cost``. Equal:
``state_bytes_per_device``, ``cache_bytes_per_device``, ``microbatches``,
``remat``. The port's dot FLOPs per device, less each named op-family
difference, within 1% of the sum of the reference's ``top_dots``; each
difference from its shape formula (:func:`named_differences`):

* ``lm_head_all_positions`` (reference, prefill): the reference projects
  every position to logits and slices the last; the port projects the last.
* ``flash_bwd_recompute`` (port, train): the flash backward's plain version
  (the kernels' structure) recomputes ``s = q kᵀ`` in both the dq and the
  dkv pass and ``dp = do vᵀ`` in both, where the autodiff of the
  reference's attention forms ``dp`` once and no ``s``.
* ``remat_unread_partials`` (port, train, model axis > 1): PyTorch's
  checkpoint recomputes each period's forward until the last saved tensor
  the backward reads, so the FFN's row-parallel ``wd`` partials of ranks 0
  .. tp - 2 (nothing reads them) are recomputed; XLA drops them.
* ``moe_dispatch_combine`` and ``moe_one_hot`` (reference): its MoE
  dispatches and combines through one-hot einsums (dots); the port through
  index writes and gathers.
* ``moe_wd_all_experts`` (port, model axis > 1): the port runs a batch
  shard's ``wd`` product over all experts on every rank (``wd`` is cut on
  the period dim, ``layers.apply_moe_ffn_shards``), the reference over the
  rank's experts.

Collectives: prefill all-reduce bytes per device equal (163,840 for llama
at 2 x 4). The reference's CPU lowering all-reduces the bf16 partial sums
in fp32 (every all-reduce in its HLO is ``f32``; XLA's float normalization
on the CPU), so the port's fp32 cell is held to it exactly and its bf16
cell to half of it. The other buckets are printed beside the reference's.
Also every arch's steps traced at bf16 on ``meta`` (reduced,
unmeshed), the cost mode counted by hand (a matmul plus an add, a
``bmm``, a ``join_sum`` over 4 ranks), and the CLI (a cell's JSON, a SKIP
cell).
"""
import json
import math
import os
import pickle
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import ARCH_REGISTRY as JAX_REGISTRY
from repro.configs.base import supports_shape as jax_supports_shape
from repro.launch import specs as jax_specs
from repro_torch.configs import ARCH_REGISTRY, SHAPES, reduced_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch.cost import CostMode
from repro_torch.models import dist
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse: this module's tests on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m")
MESHES = ((1, 1), (2, 4))
KINDS = ("train", "prefill", "decode")
B, S = 4, 64
CELLS = [(a, m, k) for a in ARCHS for m in MESHES for k in KINDS]


def _shape(kind: str) -> ShapeSpec:
    return ShapeSpec(f"r_{kind}", S, B, kind)


# ------------------------------------------------------------- full size
@pytest.mark.parametrize("arch", sorted(ARCH_REGISTRY))
def test_param_counts_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = ARCH_REGISTRY[arch], JAX_REGISTRY[arch]
    n, na = D.SP.model_param_count(cfg), D.SP.model_active_param_count(cfg)
    assert n == jax_specs.model_param_count(jcfg) and na == jax_specs.model_active_param_count(jcfg)
    for shape in SHAPES.values():
        tokens = shape.seq_len * shape.global_batch
        want = {"train": 6.0 * na * tokens, "prefill": 2.0 * na * tokens}.get(shape.kind, 2.0 * na * shape.global_batch)
        assert D.model_flops(cfg, shape, na) == want


@pytest.mark.parametrize("arch", sorted(ARCH_REGISTRY))
def test_every_arch_traces_its_steps_at_bf16_on_meta(arch):
    """Reduced and unmeshed: every step the arch has runs at bf16 on
    ``meta`` tensors and is counted (the encoder's decode is the
    reference's SKIP). The meshed traces are the parity cells below."""
    cfg = reduced_config(ARCH_REGISTRY[arch])
    for kind in KINDS:
        shape = ShapeSpec(f"t_{kind}", 16, 4, kind)
        rec = D.run_cell(arch, shape.name, False, None, cfg=cfg, shape=shape, mesh=D.meta_mesh((1, 1)))
        if cfg.is_encoder and kind == "decode":
            assert rec["status"] == "SKIP"
            continue
        assert rec["status"] == "OK", rec.get("traceback")
        assert rec["dot_flops_per_device"] > 0 and rec["state_bytes_per_device"] > 0


# ------------------------------------------------------ the reference
_CHILD = textwrap.dedent(
    """
    import os, pickle, re, sys
    os.environ["REPRO_DRYRUN_XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["REPRO_ATTN_COST_PROXY"] = "1"
    import functools
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import ARCH_REGISTRY
    from repro.configs.base import ShapeSpec, reduced_config
    from repro.launch import dryrun as D
    from repro.launch.hlo_cost import analyze, top_dots
    from repro.models import dist

    assert len(jax.devices()) == 8
    B, S = int(sys.argv[2]), int(sys.argv[3])
    cells = [(a, (1, 1), k) for a in ("llama3.2-1b", "granite-moe-3b-a800m") for k in ("train", "prefill", "decode")]
    cells += [(a, (2, 4), k) for a in ("llama3.2-1b", "granite-moe-3b-a800m") for k in ("train", "prefill", "decode")]
    cells += [("llama3.2-1b", (2, 4), "prefill-f32")]
    lower_bf16 = D.SP.input_specs
    out = {}
    for arch, ext, kind in cells:
        cfg = reduced_config(ARCH_REGISTRY[arch])
        shape = ShapeSpec("r", S, B, kind.split("-")[0])
        D.SP.input_specs = functools.partial(lower_bf16, dtype=jnp.float32) if kind.endswith("f32") else lower_bf16
        mesh = jax.make_mesh(ext, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        with dist.use_mesh(mesh):
            lowered, aux = D.lower_cell(cfg, shape, mesh)
        text = lowered.compile().as_text()
        la = analyze(text)
        out[(arch, ext, kind)] = dict(
            dot_flops=sum(r[0] for r in top_dots(text, 10**9)), collectives=dict(la["collectives"]), aux=aux,
            allreduce_types=re.findall(r"= \\(?(\\w+)\\[[\\d,]*\\][^=]*? all-reduce\\(", text))
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
    """
)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every reduced cell lowered by the reference, in one child interpreter."""
    path = tmp_path_factory.mktemp("dryrun") / "reference.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    subprocess.run([sys.executable, "-c", _CHILD, str(path), str(B), str(S)], env=env, cwd=ROOT, check=True,
                   timeout=600)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port():
    out = {}
    for arch, ext, kind in CELLS + [("llama3.2-1b", (2, 4), "prefill-f32")]:
        cfg = reduced_config(ARCH_REGISTRY[arch])
        dtype = torch.float32 if kind.endswith("f32") else torch.bfloat16
        shape = _shape(kind.split("-")[0])
        out[arch, ext, kind] = D.run_cell(arch, shape.name, False, None, cfg=cfg, shape=shape,
                                          mesh=D.meta_mesh(ext), mesh_name=f"{ext[0]}x{ext[1]}", dtype=dtype)
        assert out[arch, ext, kind]["status"] == "OK", out[arch, ext, kind].get("traceback")
    return out


def named_differences(cfg, shape: ShapeSpec, ext) -> tuple[dict, dict]:
    """The dot FLOPs per device of the op families one side has and the
    other does not (module docstring): ``(port's, reference's)``."""
    dp, tp = ext
    b_l = shape.global_batch // dp
    t_l = b_l * (shape.seq_len if shape.kind != "decode" else 1)
    t = t_l * dp
    d = cfg.d_model
    port, ref = {}, {}
    if shape.kind == "prefill":
        ref["lm_head_all_positions"] = 2.0 * b_l * (shape.seq_len - 1) * d * cfg.padded_vocab / tp
    if shape.kind == "train":
        n_attn = sum(1 for layer in cfg.all_layers if layer.mixer in ("attn", "attn_local"))
        h_l = cfg.num_heads // tp if cfg.num_heads % tp == 0 else cfg.num_heads
        hd = dv = cfg.resolved_head_dim
        port["flash_bwd_recompute"] = n_attn * 2.0 * b_l * h_l * shape.seq_len ** 2 * (2 * hd + dv)
        n_dense = sum(1 for layer in cfg.all_layers if layer.ffn == "dense")
        if tp > 1 and n_dense:
            port["remat_unread_partials"] = n_dense * 2.0 * t_l * (cfg.d_ff // tp) * d
    if cfg.moe is not None:
        moe = cfg.moe
        n_moe = sum(1 for layer in cfg.all_layers if layer.ffn == "moe")
        e, k = moe.num_experts, moe.top_k
        e_l = e // tp if e % tp == 0 else e
        g = min(4096, t)
        c = g if cfg.moe_dropless else math.ceil(k * g * 1.25 / e)
        n_disp, n_hot, n_wd = (6, 5, 4) if shape.kind == "train" else (2, 2, 1)
        ref["moe_dispatch_combine"] = n_moe * n_disp * 2.0 * e_l * c * t_l * d
        ref["moe_one_hot"] = n_moe * n_hot * 2.0 * t_l * e_l * c * k
        if tp > 1:
            port["moe_wd_all_experts"] = n_moe * n_wd * 2.0 * (e - e_l) * c * d * moe.d_expert
    return port, ref


@pytest.mark.parametrize("arch,ext,kind", CELLS, ids=[f"{a}-{m[0]}x{m[1]}-{k}" for a, m, k in CELLS])
def test_state_and_cache_bytes_and_the_train_policy_equal_the_reference(reference, port, arch, ext, kind):
    got, want = port[arch, ext, kind], reference[arch, ext, kind]["aux"]
    for key, value in want.items():
        assert got[key] == value, key
    assert ("cache_bytes_per_device" in got) == (kind == "decode")


@pytest.mark.parametrize("arch,ext,kind", CELLS, ids=[f"{a}-{m[0]}x{m[1]}-{k}" for a, m, k in CELLS])
def test_dot_flops_match_the_reference_after_the_named_differences(reference, port, arch, ext, kind):
    cfg = reduced_config(ARCH_REGISTRY[arch])
    mine, theirs = named_differences(cfg, _shape(kind), ext)
    got = port[arch, ext, kind]["dot_flops_per_device"] - sum(mine.values())
    total = reference[arch, ext, kind]["dot_flops"]
    want = total - sum(theirs.values())
    print(f"{arch} {ext} {kind}: port {port[arch, ext, kind]['dot_flops_per_device']:.0f} - {mine} = {got:.0f}; "
          f"reference {total:.0f} - {theirs} = {want:.0f}")
    assert abs(got - want) <= 0.01 * total
    if arch == "llama3.2-1b":  # every family accounted for: exact
        assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_all_reduce_bytes_equal_the_reference(reference, port, arch):
    want = reference[arch, (2, 4), "prefill"]
    assert want["allreduce_types"] and set(want["allreduce_types"]) == {"f32"}  # the CPU lowering's fp32 all-reduce
    got = port[arch, (2, 4), "prefill"]["collectives"]
    for kind in ("all-gather", "all-to-all", "reduce-scatter", "collective-permute"):
        print(f"{arch} prefill 2x4 {kind}: port {got[kind]:.0f} (model-axis joins and the batch shards' logits), "
              f"reference {want['collectives'].get(kind, 0.0):.0f}")
    if arch == "llama3.2-1b":
        assert want["collectives"]["all-reduce"] == 163840.0
        assert port[arch, (2, 4), "prefill-f32"]["collectives"]["all-reduce"] == 163840.0
        assert reference[arch, (2, 4), "prefill-f32"]["collectives"]["all-reduce"] == 163840.0
        assert 2 * got["all-reduce"] == want["collectives"]["all-reduce"]  # bf16 partial sums, half the bytes


def test_other_collective_buckets_beside_the_reference(reference, port):
    """Printed, not held: the joins behind each bucket differ by design
    (``launch.cost``: join_sum an all-reduce, join_cat and the batch shards'
    outputs an all-gather; GSPMD chooses its own)."""
    for arch, ext, kind in CELLS:
        if ext == (2, 4):
            print(arch, kind, "port", port[arch, ext, kind]["collectives"], "reference",
                  reference[arch, ext, kind]["collectives"])
            assert port[arch, ext, kind]["collectives"]["all-reduce"] > 0


# ------------------------------------------------- the cost mode by hand
def test_cost_mode_counts_a_matmul_and_an_add():
    a, b, c = (torch.empty(s, device="meta") for s in ((8, 16), (16, 4), (8, 4)))
    with CostMode() as m:
        (a @ b) + c
    dev = m.per_device()
    assert dev["dot_flops"] == 2 * 8 * 4 * 16 and dev["flops"] == 2 * 8 * 4 * 16 + 8 * 4
    assert dev["bytes"] == 4 * ((8 * 16 + 16 * 4 + 8 * 4) + (8 * 4 + 8 * 4 + 8 * 4))


def test_cost_mode_counts_a_bmm_and_skips_square_trailing_bytes():
    q, k = torch.empty(3, 5, 7, device="meta", dtype=torch.bfloat16), torch.empty(3, 7, 5, device="meta",
                                                                                 dtype=torch.bfloat16)
    with CostMode(frozenset({(5, 5)})) as m:
        torch.bmm(q, k)
    dev = m.per_device()
    assert dev["dot_flops"] == 2 * 3 * 5 * 5 * 7
    assert dev["bytes"] == 2 * (3 * 5 * 7 + 3 * 7 * 5) and m.skipped_bytes == 2 * 3 * 5 * 5


def test_join_sum_over_four_ranks_is_one_all_reduce_a_device():
    with CostMode() as m:
        x = dist.place(torch.empty(2, 8, device="meta"), 0)
        parts = [x @ dist.place(torch.empty(8, 6, device="meta"), rank=r) for r in range(4)]
        dist.join_sum(parts, x.device)
    dev = m.per_device(batch_shards=1, ranks=4)
    assert dev["dot_flops"] == 2 * 2 * 6 * 8  # one rank's product; the adds are the collective's
    assert dev["flops"] == dev["dot_flops"]
    assert dev["collectives"]["all-reduce"] == 2 * 6 * 4 and dev["collective_count"] == 1


# ----------------------------------------------------------------- CLI
def test_cli_writes_a_cell_and_a_skip_cell(tmp_path):
    D.main(["--arch", "tiny_lm", "--shape", "decode_32k", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "tiny_lm__decode_32k__pod16x16.json").read_text())
    assert rec["status"] == "OK" and rec["devices"] == 256 and rec["kind"] == "decode"
    assert rec["roofline"]["compute_s"] == rec["flops_per_device"] / 989e12
    assert rec["bottleneck"] in ("compute_s", "memory_s", "collective_s") and rec["trace_s"] >= 0
    D.main(["--arch", "hubert-xlarge", "--shape", "decode_32k", "--out", str(tmp_path)])
    skip = json.loads((tmp_path / "hubert-xlarge__decode_32k__pod16x16.json").read_text())
    ok, reason = jax_supports_shape(JAX_REGISTRY["hubert-xlarge"], SHAPES["decode_32k"])
    assert skip["status"] == "SKIP" and not ok and skip["reason"] == reason
