"""Tensor parallelism (counterpart of
``apex_tpu/transformer/tensor_parallel``; reference:
``apex/transformer/tensor_parallel``)."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (  # noqa: F401
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.data import broadcast_data  # noqa: F401
from apex_tpu_torch.transformer.tensor_parallel.layers import (  # noqa: F401
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    linear_with_grad_accumulation,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (  # noqa: F401
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (  # noqa: F401
    RNGStatesTracker,
    checkpoint,
    checkpoint_policy,
    data_parallel_rng_key,
    get_rng_tracker,
    model_parallel_rng_key,
    model_parallel_seed,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (  # noqa: F401
    VocabUtility,
    split_tensor_along_last_dim,
)
