"""chip_smoke.py's readers of a ptxas -v report: registers and spills per
kernel, and the lines that say a kernel's wgmma were serialised (phase 2
fails the bf16 chain on either)."""
import pytest

import chip_smoke

MANGLED = ("_ZN51_GLOBAL__N__f9c6a10d_18_norm_conv_chain_cu_1be5d6dc"
           "18chain_kernel_wgmmaILi{bn}EEEvNS_4ArgsE")
SERIALIZED = ("ptxas info    : (C7518) Potential Performance Loss: "
              "wgmma.mma_async instructions are serialized due to program "
              "dependence on compiler-inserted WG.DP in divergent path in "
              "the function '{name}'")
ENTRY = """ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    0 bytes stack frame, {st} bytes spill stores, {ld} bytes spill loads
ptxas info    : Used {regs} registers, used 1 barriers
ptxas info    : Compile time = 460.771 ms"""


def _report(serialized, regs, spill=0):
    """A report in the form ptxas prints for the three bf16 chain
    instantiations: the serialisation notes first, as ptxas gives them,
    then one entry a kernel."""
    names = {bn: MANGLED.format(bn=bn) for bn in (256, 128, 8)}
    lines = [SERIALIZED.format(name=names[bn]) for bn in serialized]
    lines.append("ptxas info    : 0 bytes gmem")
    lines += [ENTRY.format(name=names[bn], regs=regs[bn], st=spill,
                           ld=spill) for bn in names]
    return "\n".join(lines)


@pytest.mark.parametrize("serialized, spill", [((256, 128, 8), 0),
                                               ((), 0),
                                               ((128,), 12)])
def test_chain_report_is_read_per_instantiation(serialized, spill):
    regs = {256: 254, 128: 254, 8: 165}
    report = _report(serialized, regs, spill)
    entries = chip_smoke.ptxas_entries(report)
    assert entries == {f"chain_kernel_wgmma<{bn}>": (regs[bn], spill, spill)
                       for bn in regs}
    found = chip_smoke.ptxas_serialized(report)
    assert sorted(found) == sorted(f"chain_kernel_wgmma<{bn}>"
                                   for bn in serialized)
    for lines in found.values():
        assert len(lines) == 1 and "(C7518)" in lines[0]


def test_unnamed_serialisation_goes_to_the_entry_it_follows():
    report = "\n".join([
        ENTRY.format(name=MANGLED.format(bn=128), regs=254, st=0, ld=0),
        "ptxas info    : wgmma.mma_async instructions are serialized"])
    assert chip_smoke.ptxas_serialized(report) == {
        "chain_kernel_wgmma<128>": [
            "ptxas info    : wgmma.mma_async instructions are serialized"]}
