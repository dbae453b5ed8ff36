"""``flexflow_tpu_torch/tools/sass_compare.py``'s reading of cuobjdump listings.

cuobjdump pads every line to the widest line of its file and numbers
branch labels across the module, and a source's anonymous namespace
hashes its contents: none of these may make two functions with the same
instructions and encodings differ, and a changed instruction must. The
listings here are small hand-written ones, so no CUDA toolkit is needed.

    python -m pytest tests/test_torch_port_sass_compare.py
"""
from unittest import mock

import pytest

from flexflow_tpu_torch.tools import sass_compare

pytestmark = pytest.mark.torch_port

LISTING = """	code for sm_90a
		Function : _ZN51_GLOBAL__N__145104f5_18_flash_attention_cu_829cd90e20flash_fwd_kernelILi5EfEEvPKT0_
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/                   BRA `(.L_x_24) ;                /* 0x0000000000007947 */
.L_x_24:
        /*0020*/                   EXIT ;                          /* 0x000000000000794d */
		..........
"""


def _read(text):
    with mock.patch.object(sass_compare.subprocess, "run", return_value=mock.Mock(stdout=text)):
        return sass_compare._sass("lib.so", "cuobjdump")


@pytest.mark.parametrize("edit,same", [
    (lambda t: t.replace("829cd90e", "8e2cce9c"), True),  # another namespace hash
    (lambda t: t.replace(".L_x_24", ".L_x_91"), True),  # labels numbered across the module
    (lambda t: t.replace(" ;          /*", " ;             /*"), True),  # padding
    (lambda t: t.replace("c[0x0][0x28]", "c[0x0][0x30]"), False),  # another operand
    (lambda t: t.replace("0x00000a00ff017b82", "0x00000a00ff017b83"), False),  # another encoding
])
def test_listings_compare_by_instructions_and_encodings(edit, same):
    parent, this = _read(LISTING), _read(edit(LISTING))
    assert list(parent) == ["20flash_fwd_kernelILi5EfEEvPKT0_"]
    assert (this == parent) == same
