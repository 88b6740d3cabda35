"""Mobile device heterogeneity model (paper Sec. 7.1).

Five device classes with relative local-training speed factors calibrated
to the boards the paper uses. The base unit is seconds per local training
round of the T1 CNN; other tasks scale it. Factors are from the boards'
relative FP32 throughput (Jetson AGX ~ 11x RPi4 on small CNNs).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    name: str
    speed_factor: float  # multiplier on base local-round time
    jitter: float  # lognormal sigma for per-round variation


DEVICE_CLASSES: dict[str, DeviceClass] = {
    "D1": DeviceClass("jetson_nano", 4.0, 0.15),
    "D2": DeviceClass("jetson_nx_xavier", 2.0, 0.10),
    "D3": DeviceClass("jetson_nano_orin", 1.5, 0.10),
    "D4": DeviceClass("jetson_agx_xavier", 1.0, 0.10),
    "D5": DeviceClass("raspberry_pi_4", 8.0, 0.25),
}

# Paper simulation mix (Sec. 7.2.1): 20% D1, 20% D2, 20% D3, 40% D5.
PAPER_SIM_MIX = {"D1": 0.2, "D2": 0.2, "D3": 0.2, "D5": 0.4}
# Paper real-world mix (Sec. 7.5): 3 D1, 5 D2, 4 D3, 2 D4, 6 D5.
PAPER_CASE_STUDY_MIX = {"D1": 3, "D2": 5, "D3": 4, "D4": 2, "D5": 6}


def make_device_fleet(
    num_clients: int,
    rng: np.random.Generator,
    mix: dict[str, float] | None = None,
    base_round_time: float = 30.0,
) -> list[dict]:
    """Returns per-client dicts: {class, round_time_fn}."""
    mix = mix or PAPER_SIM_MIX
    names = list(mix)
    weights = np.asarray([mix[n] for n in names], np.float64)
    if weights.sum() > 1.5:  # absolute counts
        assign = sum(([n] * int(mix[n]) for n in names), [])
        assert len(assign) == num_clients, f"mix counts {len(assign)} != {num_clients}"
    else:
        weights = weights / weights.sum()
        counts = np.floor(weights * num_clients).astype(int)
        while counts.sum() < num_clients:
            counts[rng.integers(0, len(names))] += 1
        assign = sum(([n] * int(c) for n, c in zip(names, counts)), [])
    rng.shuffle(assign)

    fleet = []
    for cls_key in assign:
        cls = DEVICE_CLASSES[cls_key]
        mean_t = base_round_time * cls.speed_factor

        def round_time(rng_=rng, mean=mean_t, sigma=cls.jitter):
            return float(mean * rng_.lognormal(0.0, sigma))

        fleet.append({"class": cls_key, "round_time": round_time})
    return fleet
