# apxlint: fixture
# Known-bad APX202: "tensor", "rows" and "ctx" are not parallel_state
# mesh axes (those are data/pipe/context/model) nor declared here.
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel.mappings import shift


def ring_over_typo_axis(x):
    return shift(x, "tensor", 1)


def typo_members():
    mesh = ps.get_mesh()
    return mesh.members("rows"), mesh.groups["ctx"]
