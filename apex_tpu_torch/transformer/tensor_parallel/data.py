"""Batch broadcast across the tensor-parallel group (counterpart of
``apex_tpu/transformer/tensor_parallel/data.py``; reference:
``apex/transformer/tensor_parallel/data.py :: broadcast_data``): the
group's source rank (index 0 on the ``model`` axis) holds the batch and
broadcasts it; shapes and dtypes agree by construction, so there is no
handshake."""

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel.mappings import collective


def broadcast_data(keys, data: dict, datatype=None) -> dict:
    """``{k: tensor}`` for ``k`` in ``keys``, each the source rank's
    ``data[k]`` (cast to ``datatype`` when given; the reference asserts
    one dtype instead)."""
    group = ps.get_tensor_model_parallel_group()
    members = ps.get_mesh().members(ps.TENSOR_AXIS)
    src = ps.get_tensor_model_parallel_src_rank()
    out = {}
    for k in keys:
        v = data[k]
        if datatype is not None:
            v = v.to(datatype)
        out[k] = v if len(members) == 1 else collective(
            "broadcast", v, group, members, src=src)
    return out
