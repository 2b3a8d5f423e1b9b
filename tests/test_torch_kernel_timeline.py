"""The timeline tool's instrumented copies of the int8 decode and LayerNorm
backward sources, on the CPU: every phase line it looks for is in the
source exactly once, and the copy carries one ``%globaltimer`` stamp per
phase (the tool itself builds and runs the copies on the card only)."""

import pytest

from pixparse_tpu_torch.ops import _build
from pixparse_tpu_torch.tools import kernel_timeline as kt


@pytest.mark.parametrize("stem,phase_sets", [
    ("decode_attention_q8", [kt.Q8_PHASES]),
    ("layer_norm", [kt.LN_PHASES, kt.LN_SUM_PHASES]),
])
def test_timeline_copies_stamp_every_phase(stem, phase_sets):
    src = (_build.CSRC / f"{stem}.cu").read_text()
    text = src
    for phases in phase_sets:
        for _, where, line, *_ in phases:
            assert src.count(line) == 1, line
        text = kt._insert(text, phases, "g_t", "true")
    assert text.count("%%globaltimer") == sum(len(p) for p in phase_sets)
    with pytest.raises(RuntimeError, match="moved"):
        kt._insert(src.replace(phase_sets[0][0][2], ""), phase_sets[0], "g_t", "true")
