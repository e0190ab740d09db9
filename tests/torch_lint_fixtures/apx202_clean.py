# apxlint: fixture
# Known-clean APX202 twin: axes by literal, by parallel_state constant,
# by parameter default and by module alias; unresolvable names skip.
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    all_to_all,
    shift,
)

_CP = ps.CONTEXT_AXIS


def ring(x, axis="context"):
    return shift(x, axis, 1)


def ulysses(x):
    return all_to_all(x, _CP, 1, 2)


def groups(axis_name):
    mesh = ps.get_mesh()
    return (mesh.members("pipe"), mesh.groups[ps.TENSOR_AXIS],
            mesh.groups[axis_name])
