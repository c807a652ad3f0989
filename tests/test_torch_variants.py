"""The ablation tables of the kernel tools against the sources they edit:
every entry of `tools/gather_variants.py`'s VARIANTS, BACKWARD_VARIANTS and
XY_VARIANTS applies to `csrc/epipolar_gather.cu`, and every entry of
`tools/view_fuse_phases.py`'s ABLATIONS and ABLATIONS_BF16 to
`csrc/view_fuse.cu` and `csrc/view_fuse_bf16.cu`
(`view_fuse_phases.variant` raises when an old text is missing). A stale
ablation fails here, on the CPU, and not in a call on the card. The
B'-xy table's old texts each occur once, and its entries leave the source
before the xy kernel's section as it is, so that an entry changes the xy
kernel alone. Needs no JAX, no compiler and no card."""
import os

import pytest

from graspnerf_tpu_torch import build
from graspnerf_tpu_torch.tools import gather_variants as GV
from graspnerf_tpu_torch.tools import view_fuse_phases as VF

TABLES = {
    "VARIANTS": (GV.VARIANTS, GV.SRC),
    "BACKWARD_VARIANTS": (GV.BACKWARD_VARIANTS, GV.SRC),
    "XY_VARIANTS": (GV.XY_VARIANTS, GV.SRC),
    "ABLATIONS": (VF.ABLATIONS, os.path.join(build.CSRC_DIR, "view_fuse.cu")),
    "ABLATIONS_BF16": (VF.ABLATIONS_BF16,
                       os.path.join(build.CSRC_DIR, "view_fuse_bf16.cu")),
}
ENTRIES = [(table, name) for table, (entries, _) in TABLES.items()
           for name in entries]
_SOURCES = {}


def source(path):
    if path not in _SOURCES:
        with open(path) as f:
            _SOURCES[path] = f.read()
    return _SOURCES[path]


XY_SECTION = "// ------------------------------------------------- gradient with " \
    "respect to xy"


@pytest.mark.parametrize("table,name", ENTRIES,
                         ids=[f"{t}-{n}" for t, n in ENTRIES])
def test_variant_applies(table, name):
    entries, path = TABLES[table]
    src = source(path)
    out = VF.variant(src, entries[name])
    assert out != src
    if table == "XY_VARIANTS":   # the forward and B' stay as they are
        for old, _ in entries[name]:
            assert src.count(old) == 1, old
        head = src[:src.index(XY_SECTION)]
        assert out.startswith(head)
