"""Parallelism layouts (a copy of ``nos_tpu/parallel/layout.py``'s
``ParallelLayout``): the degree of each axis and the axes a mesh has.

The reference also maps a layout onto TPU slice topologies
(``required_topology``, ``hosts_required``, ``per_slice``) for the
control plane's gang scheduler; those belong to the control plane and
``tpu/topology`` and are not copied. The trainer reads the degrees
(``parallel/mesh.py::TrainMesh`` lays ranks out over them).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

AXES = ("dp", "fsdp", "tp", "pp", "sp", "ep")


@dataclass(frozen=True)
class ParallelLayout:
    """Degrees of each parallelism axis. Total chips = product of all
    axes.

      dp    - pure data parallel (replicated params)
      fsdp  - data parallel with sharded params/optimizer (zero-style)
      tp    - tensor (model) parallel: activations sharded on features
      pp    - pipeline parallel: layers partitioned into stages
      sp    - sequence/context parallel (ring attention / all-to-all)
      ep    - expert parallel (MoE experts spread over chips)
    """

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1

    def __post_init__(self):
        for name in AXES:
            if getattr(self, name) < 1:
                raise ValueError(f"{name} degree must be >= 1")

    @property
    def chips(self) -> int:
        return self.dp * self.fsdp * self.tp * self.pp * self.sp * self.ep

    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n in AXES if getattr(self, n) > 1) or ("dp",)

    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, n) for n in self.axis_names())
