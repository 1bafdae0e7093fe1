"""The recurrences' cluster plan (ops/lstm_cell.py recurrence_plan, which
the wrappers use for their refusals) against the rule in the kernel
source, csrc/recurrence.cuh's rec_plan: its constants and formulas are
read from the file. For every width of the recipes and the card tests,
in both precisions and both directions of the recurrence: the slices
cover the cells exactly once, n is at most 16, and a CTA's footprint fits
the H100's 232,448 bytes of shared memory or W_rec's slice is read from
L2. Runs on the CPU: nothing is built or launched."""

import pathlib
import re

import pytest
import torch

from lstm_rnn_tpu_torch.ops import lstm_cell as lc

SRC = (pathlib.Path(lc.__file__).resolve().parent.parent / "csrc"
       / "recurrence.cuh").read_text()
WIDTHS = (5, 125, 130, 250, 300, 512)


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_constants_are_the_source_s():
    assert lc.REC_ROWS == _const("kRecRows")
    assert lc.LANES_PER_CELL == _const("kLanesPerCell")
    assert lc.CELLS_PER_CTA == _const("kCellsPerCta")
    assert lc.MAX_CLUSTER == _const("kMaxCluster")
    assert lc.REC_MAX_THREADS == _const("kRecMaxThreads")
    assert lc.QUAD_FLOATS == _const("kQuadFloats")
    assert re.search(r"constexpr int kCellsPerWarp = 32 / kLanesPerCell;",
                     SRC)
    # n, the slices and the padded k ranges, as rec_plan writes them
    assert "int n = (H + kCellsPerCta - 1) / kCellsPerCta;" in SRC
    assert "p.cmax = (H + p.n - 1) / p.n;" in SRC
    assert "count = base + (rank < extra ? 1 : 0);" in SRC
    bwd = re.search(r"p\.kp = round_up\(4 \* H, 4 \* (\d+)\);\s*"
                    r"p\.ws = p\.kp;", SRC)
    fwd = re.search(r"p\.kp = round_up\(H, 2 \* kLanesPerCell\);\s*"
                    r"p\.ws = round_up\(H, (\d+)\) \+ (\d+);", SRC)
    assert bwd and fwd
    for kind, m in (("bwd", bwd), ("fwd", fwd)):
        if kind == "bwd":
            step, pad = 4 * int(m.group(1)), 0
        else:
            step, pad = int(m.group(1)), int(m.group(2))
        for H in WIDTHS:
            ws = -(-(4 * H if kind == "bwd" else H) // step) * step + pad
            gates = 1 if kind == "bwd" else 4
            cpad = lc._round_up(-(-H // lc.recurrence_plan(
                H, torch.float32, kind)["n"]), lc.CELLS_PER_WARP)
            assert lc.recurrence_plan(H, torch.float32, kind)["w"] == \
                cpad * ws * gates * 4


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", WIDTHS)
def test_plan_covers_the_cells_and_fits(H, dtype, kind):
    p = lc.recurrence_plan(H, dtype, kind)
    assert 1 <= p["n"] <= 16 and len(p["slices"]) == p["n"]
    cells = []
    for start, count in p["slices"]:
        assert count >= 1
        cells += range(start, start + count)
    assert cells == list(range(H))  # every cell exactly once, in order
    counts = [c for _, c in p["slices"]]
    assert max(counts) - min(counts) <= 1
    assert p["ok"] and p["threads"] <= lc.REC_MAX_THREADS
    assert p["threads"] >= lc.LANES_PER_CELL * max(counts)
    assert p["state"] <= lc.SMEM_OPTIN
    if p["w_on_chip"]:
        assert p["smem"] == p["state"] + p["w"] <= 232_448
    else:
        assert p["state"] + p["w"] > 232_448 and p["smem"] == p["state"]


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_recipe_widths_keep_w_rec_on_chip(kind):
    """TIMIT (H = 125) and the streaming stack (H = 250) keep W_rec on
    chip in both precisions; f32 at H = 512 takes the L2 route."""
    for H in (125, 250):
        for dtype in (torch.float32, torch.bfloat16):
            assert lc.recurrence_plan(H, dtype, kind)["w_on_chip"]
    assert not lc.recurrence_plan(512, torch.float32, kind)["w_on_chip"]
    assert lc.recurrence_plan(125, torch.float32, kind)["n"] == 8


def test_refuses_a_width_no_cta_takes():
    with pytest.raises(ValueError, match="too wide"):
        lc._check_plan(4096, torch.float32, "bwd")
    lc._check_plan(512, torch.float32, "bwd")
