"""The port's roofline accounting against the JAX package's, on the CPU.

``roofline.analytic`` is the reference's arithmetic over the port's
configs: its FLOPs, bytes and FLOP breakdown must equal the reference's
exactly (the same operations in the same order on Python floats) for
every architecture x shape that ``applicable`` admits.
``roofline.analysis`` keeps the reference's report; only ``HW`` differs
(the H100's peaks).  ``roofline.counters`` counts collectives while a
step runs, under a ``fake`` process group (collectives that move
nothing), in a subprocess: the group is process-global.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.roofline import analysis as j_an
from repro.roofline import analytic as j_ay
from repro.roofline.hlo import parse_collectives_hierarchical
from repro_torch.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro_torch.roofline import analysis as t_an
from repro_torch.roofline import analytic as t_ay

SRC = Path(__file__).resolve().parents[1] / "src"

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES
         if applicable(get_config(a), SHAPES[s])[0]]


def test_configs_and_cells_match_the_reference():
    assert list(ARCH_IDS) == list(J_ARCH_IDS)
    assert list(SHAPES) == list(J_SHAPES)
    assert len(CELLS) > len(ARCH_IDS)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}:{s}" for a, s in CELLS])
def test_analytic_equals_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    sh, jsh = SHAPES[shape], J_SHAPES[shape]
    assert t_ay.flops_breakdown(cfg, sh) == j_ay.flops_breakdown(jcfg, jsh)
    for remat in ("full", "dots", None):
        assert (t_ay.analytic_flops(cfg, sh, remat)
                == j_ay.analytic_flops(jcfg, jsh, remat))
    assert t_ay.analytic_bytes(cfg, sh) == j_ay.analytic_bytes(jcfg, jsh)


def test_hw_holds_the_h100_peaks():
    """bf16 dense tensor-core peak, HBM3 bandwidth, NVLink 4's per-GPU
    bandwidth in one direction and the HBM3 capacity (NVIDIA H100 SXM
    data sheet)."""
    assert t_an.HW == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
                       "link_bw": 450e9, "hbm_bytes": 80e9}
    assert t_an._MULT == j_an._MULT
    assert t_an._DTYPE_BYTES == j_an._DTYPE_BYTES


def test_model_flops_conventions():
    for kind in ("train", "prefill", "decode"):
        assert (t_an.model_flops(1000, 10, kind)
                == j_an.model_flops(1000, 10, kind))
    assert t_an.model_flops(1000, 10, "train") == 6000 * 10


def test_roofline_report_matches_the_reference():
    """The reference test's inputs: with the reference's ``HW`` passed
    as ``hw`` the two reports are equal; with the default (the H100's)
    each term is the same numerator over the H100's peak."""
    kw = dict(flops_per_dev=197e12, bytes_per_dev=819e9, n_chips=256,
              model_flops_total=197e12 * 256)
    t_coll = t_an.CollectiveStats({"all-reduce": 50e9}, {"all-reduce": 4})
    j_coll = j_an.CollectiveStats({"all-reduce": 50e9}, {"all-reduce": 4})
    assert (t_an.roofline_report(coll=t_coll, hw=j_an.HW, **kw)
            == j_an.roofline_report(coll=j_coll, **kw))
    rep = t_an.roofline_report(coll=t_coll, **kw)
    assert rep["compute_s"] == pytest.approx(197e12 / 989e12)
    assert rep["memory_s"] == pytest.approx(819e9 / 3.35e12)
    assert rep["collective_s"] == pytest.approx(50e9 / 450e9)
    assert rep["dominant"] == "memory_s"
    assert rep["step_lower_bound_s"] == rep["memory_s"]
    assert rep["roofline_fraction"] == pytest.approx(
        rep["compute_s"] / rep["memory_s"])
    assert t_coll.total_bytes == 50e9


_HLO = textwrap.dedent("""
    HloModule jit_f

    %cond.1 (arg.1: (s32[], f32[64,256])) -> pred[] {
      %p = (s32[], f32[64,256]) parameter(0)
      %i = s32[] get-tuple-element(%p), index=0
      %c = s32[] constant(24)
      ROOT %lt = pred[] compare(%i, %c), direction=LT
    }

    %body.1 (arg.2: (s32[], f32[64,256])) -> (s32[], f32[64,256]) {
      %p = (s32[], f32[64,256]) parameter(0)
      %x = f32[64,256]{1,0} get-tuple-element(%p), index=1
      %ar = f32[64,256]{1,0} all-reduce(f32[64,256]{1,0} %x), to_apply=%sum
      ROOT %t = (s32[], f32[64,256]) tuple(%i, %ar)
    }

    ENTRY %main.1 (a: f32[64,256]) -> f32[64,256] {
      %a = f32[64,256]{1,0} parameter(0)
      %ag = f32[128,256]{1,0} all-gather(f32[64,256]{1,0} %a), dimensions={0}
      %w = (s32[], f32[64,256]) while((s32[], f32[64,256]) %t0), condition=%cond.1, body=%body.1
      ROOT %out = f32[64,256]{1,0} get-tuple-element(%w), index=1
    }
""")

# the HLO above as an eager step on a 2-rank world: an all-gather of a
# (64, 256) f32 shard, then 24 all-reduces of a (64, 256) f32 tensor in
# a loop, each after a (64, 256) x (256, 256) product
_COUNT_PROG = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fcol
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.roofline.counters import count_collectives

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=2)

    def step(a, w, functional):
        g = torch.empty(128, 256)
        dist.all_gather_into_tensor(g, a)
        x = g[:64]
        for _ in range(24):
            x = x @ w
            if functional:
                x = fcol.wait_tensor(fcol.all_reduce(x, "sum",
                                                     dist.group.WORLD))
            else:
                dist.all_reduce(x)
        dist.send(x, 1)
        dist.recv(x, 1)
        return x

    out = {}
    for functional in (True, False):
        _, st, flops = count_collectives(step, torch.ones(64, 256),
                                         torch.eye(256), functional)
        out[str(functional)] = [st.bytes_by_op, st.count_by_op, flops]
    dist.destroy_process_group()
    print("COUNTS", json.dumps(out))
""")


def test_counter_counts_each_execution():
    """A collective inside a 24-step loop counts 24 times, as the
    reference's loop-aware HLO parse multiplies the body by its trip
    count; the all-gather once, on its operand shard; a send as a
    collective-permute of its tensor, a recv not (its bytes are the
    peer's send); the FLOPs of the 24 products."""
    r = subprocess.run([sys.executable, "-c", _COUNT_PROG],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(SRC)})
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("COUNTS")]
    assert line, r.stderr[-2000:]
    got = json.loads(line[0].split(" ", 1)[1])
    ref = parse_collectives_hierarchical(_HLO, default_trip=1)
    for functional in ("True", "False"):
        by_op, count, flops = got[functional]
        assert count == {"all-gather": 1, "all-reduce": 24,
                         "collective-permute": 1}
        assert count["all-reduce"] == ref.count_by_op["all-reduce"]
        assert by_op["all-reduce"] == ref.bytes_by_op["all-reduce"]
        assert by_op["all-gather"] == ref.bytes_by_op["all-gather"]
        assert by_op["all-reduce"] == 24 * 64 * 256 * 4 * 2.0
        assert by_op["collective-permute"] == 64 * 256 * 4
        assert flops == 24 * 2 * 64 * 256 * 256
