"""The LM dry run's decode_32k cells of the recurrent families (mamba2-2.7b's
SSD blocks, recurrentgemma-9b's RG-LRU blocks beside local attention over a
ring of 2,048 slots): the checks of ``test_torch_lm_dryrun_decode.py``.
Their states stay whole on every model rank, as the reference's heuristic
leaves them (no dim equals a cache length)."""
import pytest

from test_torch_lm_dryrun_decode import check_decode_cell


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_one_decode_cell_a_recurrent_family(arch):
    check_decode_cell(arch)
