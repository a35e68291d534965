"""The sizing of the wide step (r = 4, 8, 16) of the dense line kernels, on the
CPU: the Python mirrors that pick a launch width from shapes alone
(``thomas_kernels.line_smem_bytes``, ``line_fits``, ``line_width``) and the
exchange buffers a launch takes (``Exchange.values``, ``row_values``) held
to the constants read from ``csrc/thomas_flow.cuh`` (``wide_smem_bytes``,
``wide_ksteps``, ``wide_groups``, ``wide_stage_rows``, ``wide_stage_bytes``,
``wide_pub_floats``, ``wide_slot_bytes``),
at the lines of the 401^2 and 801^2 solves (ld 408, 808) and at two long
ones (1760, 2144).  The kernels themselves run only on the card
(``tests/test_torch_cuda_kernels.py``: ``test_wide_line_step_matches_plain``,
``test_longest_line_fits``)."""

import re
from pathlib import Path

import pytest
import torch

from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk
from torch_threads import few_threads  # noqa: F401

H100_SMEM = 232_448


def _csrc(pattern: str, name: str = "thomas_flow.cuh") -> list:
    src = (Path(tk.__file__).resolve().parents[1] / "csrc" / name).read_text()
    found = re.search(pattern, src)
    assert found, pattern
    return [int(v) for v in found.groups()]


def _kernel_sizing():
    """The wide step's sizing as the kernels compute it, from their sources."""
    threads1, threads2 = _csrc(r"return SPLIT == 1 \? (\d+) : (\d+);")
    groups1, groups2 = _csrc(r"flow_groups\(\) \{\n  return SPLIT == 1 \? (\d+) : (\d+);")
    pitch_add, = _csrc(r"return flow_threads<SPLIT>\(\) / 32 \+ (\d+);")
    ks_add, ks_div = _csrc(r"wide_ksteps\(int cmax\) \{ return \(cmax \+ (\d+)\) / (\d+); \}")
    g16, g8, g4 = _csrc(r"wide_groups\(\) \{ return R == 16 \? (\d+) : R == 8 \? (\d+) : (\d+); \}")
    extra, = _csrc(r"wide_stage_rows\(int cmax\) \{ return cmax \+ (\d+); \}")
    slot, = _csrc(r"return \(size_t\)(\d+) \* r \* ld;")
    lanes, = _csrc(r"constexpr int kLanes = (\d+);", "thomas_line.cuh")
    block, = _csrc(r"constexpr int kScaleBlock = (\d+);", "thomas_line.cuh")
    ring, = _csrc(r"constexpr int kSlots = (\d+);")
    pub16, pub = _csrc(r"wide_pub_floats\(\) \{ return R == 16 \? (\d+) : (\d+); \}")
    edge_pad, = _csrc(r"slice_rows<SPLIT>\(ld\) / kLanes \+ (\d+)\);")
    wide_stages, = _csrc(r"constexpr int kWideStages = (\d+);")
    sp_round, sp_add = _csrc(r"return \(16 \* wide_ksteps\(cmax\) \+ 31\) / 32 \* (\d+) \+ (\d+);")

    def slice_rows(ld, split):
        return lanes * -(-(ld // lanes) // split)

    def smem(ld, r, storage, split):
        threads = threads1 if split == 1 else threads2
        cmax = slice_rows(ld, split)
        red = 4 * 2 * (2 * r * lanes) * (threads // 32 + pitch_add)
        ksteps = (cmax + ks_add) // ks_div
        frags = ksteps * {16: g16, 8: g8, 4: g4}[r] * 32 * 16
        w = 4 * 2 * r * (-(-16 * ksteps // 32) * sp_round + sp_add)
        scales = 4 * 2 * lanes * -(-ld // block) if storage == "int8" else 0
        stage = 2 * (cmax + extra) * (8 if storage == "int8" else 16) + scales
        if r == 16:      # the edge terms the rows' copy stages in a stage buffer
            tiles = ld // lanes
            stage = max(stage, 8 * 2 * r * (tiles + tiles % 2 if split == 1
                                            else cmax // lanes + edge_pad))
        return 64 + red + 4 * 32 * (pub16 if r == 16 else pub) + w + frags + wide_stages * stage

    def fits(ld, r, storage, split):
        rows = (groups1 * threads1) if split == 1 else (groups2 * threads2)
        return smem(ld, r, storage, split) <= H100_SMEM and slice_rows(ld, split) <= rows

    return smem, fits, slot, ring, lanes


@pytest.mark.parametrize("storage", ["bf16", "int8"])
@pytest.mark.parametrize("r", [4, 8, 16])
@pytest.mark.parametrize("ld", [408, 808, 1760, 2144])
def test_wide_sizing_mirrors_the_kernels(storage, r, ld):
    """``line_smem_bytes`` and ``line_fits`` say what the kernels' own sizing
    says, on one CTA a tile and on two; the 401^2 and 801^2 lines take one
    CTA a tile at r = 4, 8 and 16 (as the launcher picks: one where one
    fits); ``line_width`` launches the widest width the kernels' sizing takes
    (at 2144 lanes in bf16, four of eight and of sixteen)."""
    smem, fits, _, _, _ = _kernel_sizing()
    assert tk.SMEM_PER_BLOCK == H100_SMEM
    for split in (1, 2):
        assert tk.line_smem_bytes(ld, r, storage, split=split) == smem(ld, r, storage, split)
    assert tk.line_fits(ld, r, storage) == (fits(ld, r, storage, 1) or fits(ld, r, storage, 2))
    if ld <= 808:
        assert fits(ld, r, storage, 1)
    planes = torch.zeros((), dtype=torch.bfloat16 if storage == "bf16" else torch.int8)
    planes = planes.expand(1, 1, ld // 8, ld, 8)
    bands = torch.zeros(()).expand(1, 1, 2, 3, ld)
    scale = None if storage == "bf16" else torch.ones((1, 1, ld // 8, tk.n_scale_blocks(ld), 2, 8))
    fac = tk.ThomasFactorization(planes, planes, bands, bands, ld - 7, scale=scale)
    widest = next(w for w in (16, 8, 4, 2, 1) if w <= r and (fits(ld, w, storage, 1) or fits(
        ld, w, storage, 2) or w <= 2))
    assert tk.line_width(fac, r) == widest


@pytest.mark.parametrize("r", [4, 8, 16])
@pytest.mark.parametrize("ld", [408, 808, 1760, 2144])
@pytest.mark.parametrize("batch,slots", [(1, tk.EXCHANGE_LINES), (16, tk.EXCHANGE_LINES),
                                         (1, 70)])
def test_wide_exchange_holds_a_launch(r, ld, batch, slots):
    """A wide launch's exchange: its rows buffer holds ``slots`` slots of
    ``wide_slot_bytes`` a batch row (the ring of four of the dense passes, or
    one slot a line of the cached pass), zero when made, and grows only for a
    launch that needs more; its flags, one 8-byte word a tile and CTA of each
    slot and batch row, fit the words buffer that ``Exchange.values`` sizes
    for the launch, so that the words buffer never grows for them."""
    _, _, slot, ring, lanes = _kernel_sizing()
    assert ring == tk.EXCHANGE_LINES and slot == tk.WIDE_SLOT_BYTES
    assert tk.Exchange.row_values(batch, r, ld, slots) * 4 == slots * batch * slot * r * ld
    stride, = _csrc(r"constexpr int kFlagStride = (\d+);")
    flags = slots * batch * 2 * (ld // lanes) * stride
    assert flags <= tk.Exchange.values(batch, r, ld, slots)
    ex = tk.Exchange("cpu")
    words, epoch = ex.take(batch, r, ld, 52, slots=slots)
    rows = ex.wide_rows(batch, r, ld, slots=slots)
    assert rows.dtype == torch.float32 and not rows.any() and epoch == 1
    assert rows.numel() == tk.Exchange.row_values(batch, r, ld, slots)
    assert ex.wide_rows(1, r, 408, slots=1) is rows            # smaller: the same buffer
    assert ex.wide_rows(batch, 2, ld, slots=slots) is None      # the narrow step takes none
    assert ex.take(batch, r, ld, 52, slots=slots) == (words, 53)
    assert ex.wide_rows(batch, r, ld, slots=slots) is rows
