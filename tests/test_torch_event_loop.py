"""The edits that ``chip_smoke.py`` makes to the census kernel's source to read its
event loop on the card: each anchor of the loop's paths (``LOOP_PATHS``: the SASS
of a scatter in the cell, a crossing, any outcome but a wall, the whole loop) and
of the counting variant (``PATH_MIX``: the warp path mix) must name one line of
the kernel's body, ``csrc/transport_kernel.cuh``, or the readings fail on the card.
No GPU needed.
"""

import os
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import chip_smoke as cs  # noqa: E402

CSRC = os.path.join(_ROOT, "jaybenne_tpu_torch", "csrc")
KERNEL = os.path.join(CSRC, cs.KERNEL_BODY)


def _source(path=KERNEL):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("path", sorted(cs.LOOP_PATHS))
def test_loop_path_traps_apply_to_the_kernel(path):
    """Each path's traps go in front of lines the kernel holds once (at most once
    where optional): the patched source holds the traps of every edit whose line
    is there, and the whole loop ("full") is the source itself."""
    src = _source()
    out = cs.patched(src, cs.LOOP_PATHS[path], path)
    traps = sum(line.count("__trap()") for anchor, line, _ in cs.LOOP_PATHS[path]
                if src.count(anchor) == 1)
    assert out.count("__trap()") - src.count("__trap()") == traps
    assert (path == "full") == (out == src)


def test_path_mix_counters_apply_to_the_kernel():
    """The counting variant's edits apply once each, every counter key is written,
    and its reader comes after the kernel's entry points (the float32 census's
    source, which includes the body)."""
    src = _source()
    entry = _source(os.path.join(CSRC, "transport_kernel.cu"))
    assert f'#include "{cs.KERNEL_BODY}"' in entry
    out = cs.patched(src, cs.PATH_MIX, "path mix") + entry + cs.PATH_MIX_READ
    assert out.count("jb_path_mix[") == src.count("jb_path_mix[") + 1 + 6
    assert f"jb_path_mix[{len(cs.PATH_MIX_KEYS)}]" in out
    assert out.index("jb_transport_occupancy") < out.index("jb_path_mix_read")
    # the flags are set inside the IMC branch and after the DDMC event, and read
    # where every event ends
    assert out.index("pm_scatter = scatter;") < out.index("const unsigned m = __activemask();")
    assert (out.index("ddmc_event<NDIM, ABSORB, kCell>(g, o.seed") < out.index("pm_leak = leak != 0;")
            < out.index("pm_scatter = scatter;"))


def test_patched_refuses_a_missing_or_repeated_anchor():
    """An anchor the kernel lacks, or holds twice, fails loudly instead of reading
    another loop."""
    src = "a\nb\nb\n"
    with pytest.raises(AssertionError):
        cs.patched(src, (("c\n", "x\n", True),), "missing")
    with pytest.raises(AssertionError):
        cs.patched(src, (("b\n", "x\n", False),), "repeated")
    assert cs.patched(src, (("c\n", "x\n", False),), "optional") == src
    assert cs.patched(src, (("a\n", "x\n", True),), "once") == "x\na\nb\nb\n"


@pytest.mark.parametrize("slots, resident, want", [
    (201152, 6, True),   # stepdiff's census: 786 blocks, transport_1d holds 6 a SM
    (167408, 5, True),   # the 2D feedback census: 654 blocks, transport_2d_abs 5 a SM
    (863168, 4, False),  # the 64^3 feedback census: 3372 blocks, transport_3d_abs 4 a SM
    (206144, 4, False),  # stepdiff_smr's census: 806 blocks, transport_2d_smr 4 a SM
    (132 * 6 * 256, 6, True),
    (132 * 6 * 256 + 1, 6, False),
])
def test_a_launch_spreads_its_slots_only_when_it_fits_on_the_card(slots, resident, want):
    """The census launch spreads each block's warps over the ledger only when all
    its blocks are resident at once on 132 SMs (one wave): the paths' ledgers."""
    from jaybenne_tpu_torch.ops import transport_kernel as tk

    assert tk.spreads(slots, 132, resident) == want


@pytest.mark.parametrize("slots, resident, rounds, want", [
    (201152, 4, True, (1, 528)),   # stepdiff f64's census: transport_1d_f64, 4 a SM
    (201152, 4, False, (0, 0)),    # one thread a slot: its 786 blocks do not fit at once
    (201152, 6, False, (1, 0)),    # transport_1d's census: 786 blocks fit, spread
    (2 * 528 * 256, 4, True, (1, 528)),      # two rounds
    (2 * 528 * 256 + 1, 4, True, (0, 0)),    # three: one thread a slot, in order
    (804608, 4, True, (0, 0)),     # four times stepdiff's ledger
    (256, 4, True, (1, 528)),      # one block's slots: the kernel launches one block
])
def test_a_rounds_launch_takes_the_resident_grid(slots, resident, rounds, want):
    """(spread, grid) of a census launch on 132 SMs: an instantiation that runs in
    rounds (the float64 uniform 1D routes) is bounded by the card's resident grid,
    each round's slots spread over it, where its slots take at most two rounds;
    a longer ledger, and any other instantiation, takes one thread a slot and
    spreads only where its blocks fit at once."""
    from jaybenne_tpu_torch.ops import transport_kernel as tk

    assert tk.launch_shape(slots, 132, resident, 2 if rounds else 0) == want


@pytest.mark.parametrize("slots, resident, want", [
    (221504, 3, (1, 396)),             # stepdiff_smr's ep_bremss census in float64
    (4 * 396 * 256, 3, (1, 396)),      # four rounds
    (4 * 396 * 256 + 1, 3, (0, 0)),    # five: one thread a slot, in order
])
def test_the_nongray_forest_takes_up_to_four_rounds(slots, resident, want):
    """(spread, grid) of the float64 non-gray census on a 2D forest, which runs in
    rounds on the resident grid where its slots take at most four
    (csrc/transport_kernel.cuh kRoundsMax): its lanes run two events or so, so the
    rounds past its live slots are short."""
    from jaybenne_tpu_torch.ops import transport_kernel as tk

    assert tk.launch_shape(slots, 132, resident, 4) == want


def test_loop_body_reads_the_event_loop_inside_rounds():
    """``loop_body`` reads the widest loop that holds no barrier: in a census that
    runs in rounds (a barrier in each round) its event loop, not the rounds."""
    code = [(0x00, "MOV R1, c[0x0][0x28] ;"), (0x10, "BAR.SYNC.DEFER_BLOCKING 0x0 ;"),
            (0x20, "DADD R2, R2, R4 ;"), (0x30, "DMUL R2, R2, R6 ;"),
            (0x40, "@P0 BRA 0x20 ;"), (0x50, "ISETP.GE.AND P1, PT, R8, R9, PT ;"),
            (0x60, "@!P1 BRA 0x10 ;"), (0x70, "EXIT ;")]
    assert cs.loop_body(code) == 3
    without = [(a, "NOP ;" if "BAR" in t else t) for a, t in code]
    assert cs.loop_body(without) == 6


_PTXAS = """ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    {stack} bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads
ptxas info    : Used {regs} registers, used 1 barriers, 8 bytes smem
"""
_MANGLED = "_ZN12_GLOBAL__N_116transport_kernelILi{}ELb{}ELb{}ELb{}ELb{}E{}EEvNS_6LedgerIT4_EE"


@pytest.mark.parametrize("args, route, regs, stack, spill", [
    ((1, 0, 0, 0, 0, "f"), "transport_1d", 32, 0, 0),
    ((1, 0, 0, 1, 0, "d"), "transport_1d_smr_f64", 60, 0, 0),
    ((2, 0, 0, 1, 0, "d"), "transport_2d_smr_f64", 78, 40, 0),
    ((3, 1, 1, 1, 0, "d"), "transport_3d_abs_ddmc_smr_f64", 128, 40, 4),
    ((1, 0, 0, 0, 0, "d"), "transport_1d_f64", 60, 0, 0),
    ((1, 0, 1, 0, 0, "d"), "transport_1d_ddmc_f64", 53, 0, 0)])
def test_kernel_resources_are_read_from_ptxas(args, route, regs, stack, spill):
    """``census_route`` names a census instantiation from its mangled name, float32
    or float64, and ``kernel_resources`` reads its registers, stack frame and
    spills from nvcc's ``-Xptxas -v`` output (phase 2's residency floors read
    them), beside a kernel that is no census."""
    from jaybenne_tpu_torch.ops import transport_kernel

    fn = _MANGLED.format(*args)
    log = (_PTXAS.format(name=fn, stack=stack, spill=spill, regs=regs)
           + _PTXAS.format(name="_Z11raw_bits_kPKjS0_Pji", stack=0, spill=0, regs=16))
    assert cs.census_route(fn, transport_kernel) == route
    assert cs.kernel_resources(log, transport_kernel) == {
        route: {"registers": regs, "stack": stack, "spill_stores": spill, "spill_loads": spill}}
