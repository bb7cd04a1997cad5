"""Roofline terms of a step, per card, on the NVIDIA H100.

Three terms (seconds, per step), all per card:
  compute    = FLOPs_per_device / peak_FLOPs
  memory     = bytes_per_device / HBM_bw
  collective = link_bytes_per_device / link_bw

The FLOPs and bytes come from ``roofline.analytic`` (the JAX package
reads them from XLA's ``cost_analysis()`` beside it).  The collective
bytes are each collective's shard-shaped operand or result size times
the ring algorithm's wire multiplier (``_MULT``: an all-reduce moves ~2x
its operand; an all-gather ~the gathered result; reduce-scatter and
all-to-all ~their operand).  The JAX package parses them from the
compiled HLO text (``parse_collective_bytes``); a PyTorch program has no
HLO, so the port counts them while the program runs
(``roofline.counters.count_collectives``), once per execution.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["HW", "CollectiveStats", "roofline_report", "model_flops"]

# NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU data sheet; dense,
# no sparsity, at the 700 W board power): bf16 tensor-core peak, HBM3
# bandwidth, NVLink 4's per-GPU bandwidth in one direction (18 links
# x 25 GB/s; 900 GB/s both ways), which a ring's sends share, and the
# HBM3 capacity the dry run holds a rank's peak against.
HW = {
    "peak_flops_bf16": 989e12,   # FLOP/s per card
    "hbm_bw": 3.35e12,           # B/s per card
    "link_bw": 450e9,            # B/s per card, NVLink 4, one direction
    "hbm_bytes": 80e9,           # B per card
}

# bytes an element, by the HLO element-type names the JAX package uses
_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1,
    "f8e5m2": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

# wire-bytes multiplier per op (ring algorithms, large-n limit)
_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-permute": 1.0}


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: dict
    count_by_op: dict

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_op.values()))


def model_flops(n_active_params: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D forward-only."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens


def roofline_report(*, flops_per_dev: float, bytes_per_dev: float,
                    coll: CollectiveStats, n_chips: int,
                    model_flops_total: float,
                    hw: Optional[dict] = None) -> dict:
    hw = hw or HW
    t_compute = flops_per_dev / hw["peak_flops_bf16"]
    t_memory = bytes_per_dev / hw["hbm_bw"]
    t_coll = coll.total_bytes / hw["link_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = model_flops_total / n_chips / hw["peak_flops_bf16"]
    return {
        "irreducible_bytes_floor_s": None,   # set by caller for decode

        **terms,
        "dominant": dominant,
        "step_lower_bound_s": bound,
        "roofline_fraction": useful / bound if bound > 0 else 0.0,
        "model_flops_total": model_flops_total,
        "hlo_flops_per_dev": flops_per_dev,
        "useful_flops_ratio": (model_flops_total / n_chips
                               / flops_per_dev) if flops_per_dev else 0.0,
        "collective_bytes_by_op": coll.bytes_by_op,
        "collective_count_by_op": coll.count_by_op,
    }
