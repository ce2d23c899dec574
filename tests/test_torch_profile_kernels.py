"""``vaura_tpu_torch.profile_kernels`` inserts its clock stamps at anchor
lines of the CUDA sources; an edit of a source that loses an anchor must
show here, on the CPU, not on the card."""

import pytest

from vaura_tpu_torch import profile_kernels as pk


@pytest.mark.parametrize("name", sorted(pk.STAMPS))
def test_every_stamp_anchor_occurs_once(name):
    src = pk.stamped_source(name)
    stamps = pk.STAMPS[name][-1]
    for k in range(len(stamps)):
        assert src.count(f"vt_prof[{k}] = clock64();") == 1
    assert src.count("vt_read_prof") == 1
    # every stamp sits inside the kernel, after the stamping thread is known
    assert src.index("vt_prof[0] = clock64()") > src.index("threadIdx.x")
