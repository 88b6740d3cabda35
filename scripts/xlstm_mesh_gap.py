"""xlstm-1.3b at full width and cut depth on the pod mesh against no mesh,
on the CPU: the bound behind ``chip_smoke.py``'s ``XLSTM_MESH_ATOL``.

    PYTHONPATH=src python scripts/xlstm_mesh_gap.py [PERIODS ...]

For each depth (periods of 8 blocks; default 1 and 2) serves batch 2,
prompt 64, 4 tokens (phase 3o's ``XLSTM_MESH_SERVE``) through
``launch.serve.serve`` without a mesh and on the pod mesh over the ``cpu``
device repeated, and prints the max |logits| gap at each position; then the
unmeshed forward's move under one ulp on the embeddings (the model's own
conditioning). About 2 GB and 30 s a period of memory and time.
"""
import dataclasses
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import forward


def main(periods: list[int]) -> None:
    cpu = torch.device("cpu")
    for n in periods:
        cfg = dataclasses.replace(get_config("xlstm-1.3b"), num_periods=n)
        kw = dict(batch=2, prompt=64, gen=4, device="cpu", keep_logits=True, verbose=False)
        plain = serve.serve(cfg, **kw)
        meshed = serve.serve(cfg, params=plain["params"], mesh=make_production_mesh(devices=[cpu] * 256), **kw)
        gaps = [(a - b).abs().max().item() for a, b in zip(plain["logits"], meshed["logits"])]
        params = plain["params"]
        with torch.no_grad():
            tokens = plain["prompts"]
            want = forward(cfg, params, {"tokens": tokens})[0]
            nudged = dict(params, embed=torch.nextafter(params["embed"], torch.full_like(params["embed"], torch.inf)))
            ulp = (forward(cfg, nudged, {"tokens": tokens})[0] - want).abs().max().item()
        same = bool((plain["tokens"] == meshed["tokens"]).all())
        print(f"xlstm-1.3b, {n} period(s) ({cfg.param_count():,} parameters): mesh against no mesh, max |logits| gap "
              f"by position {[f'{g:.3g}' for g in gaps]} (max {max(gaps):.3g}), tokens equal {same}; one ulp on the "
              f"embeddings moves the unmeshed forward {ulp:.3g}")


if __name__ == "__main__":
    torch.set_num_threads(4)
    main([int(a) for a in sys.argv[1:]] or [1, 2])
