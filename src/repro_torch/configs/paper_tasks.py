"""The paper's own client models (Sec. 7.1), used by the protocol-level
experiments and benchmarks. Small MLPs matching the paper's model sizes:

  T1 image recognition:  2 conv + 1 fc   -> here: 2 hidden-layer MLP on the
  T2 HAR:                2 fc                synthetic feature tasks (the
  T3 sound detection:    2 conv + 2 fc       synthetic data is featurized,
  T4 file cleaning:      2 conv + 2 fc       so convs become dense layers)

These run real federated training on CPU inside the benchmarks, so they
must stay tiny. They use the same init/apply machinery as the big zoo so
the EchoPFL core is exercised identically.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MLPTaskConfig:
    name: str
    input_dim: int
    hidden: tuple[int, ...]
    num_classes: int


PAPER_TASKS: dict[str, MLPTaskConfig] = {
    "image_recognition": MLPTaskConfig("image_recognition", 128, (128, 64), 10),
    "har": MLPTaskConfig("har", 64, (64,), 6),
    "sound_detection": MLPTaskConfig("sound_detection", 96, (96, 64), 9),
    "file_cleaning": MLPTaskConfig("file_cleaning", 128, (64, 32), 2),
}
