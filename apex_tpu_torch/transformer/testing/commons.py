"""Shared test-rig helpers (counterpart of
``apex_tpu/transformer/testing/commons.py``; reference:
``apex/transformer/testing/commons.py``): the mesh's bring-up, the
seeding of the tensor-parallel RNG tracker and the section banner."""

from typing import Optional

import torch

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel import random as tp_random
from apex_tpu_torch.utils import prng


def initialize_distributed(tensor_model_parallel_size: int = 1,
                           pipeline_model_parallel_size: int = 1,
                           virtual_pipeline_model_parallel_size:
                           Optional[int] = None,
                           context_parallel_size: int = 1, device=None):
    """Build the global mesh afresh (ref: starts the torch process group,
    then ``parallel_state.initialize_model_parallel``; here ``device``
    starts the default process group when none exists)."""
    ps.destroy_model_parallel()
    return ps.initialize_model_parallel(
        tensor_model_parallel_size_=tensor_model_parallel_size,
        pipeline_model_parallel_size_=pipeline_model_parallel_size,
        virtual_pipeline_model_parallel_size_=(
            virtual_pipeline_model_parallel_size),
        context_parallel_size_=context_parallel_size, device=device)


def set_random_seed(seed: int) -> torch.Tensor:
    """Seed the tensor-parallel RNG tracker and return a root key (the
    reference seeds the global RNGs and the CUDA RNG tracker; the port's
    keys are explicit ``utils.prng`` keys, the JAX package's bits)."""
    tracker = tp_random.get_rng_tracker()
    tracker.reset()
    tracker.add("model-parallel-rng", seed + 2718)
    return prng.PRNGKey(seed)


def print_separator(message: str) -> None:
    """The reference's test-section banner."""
    print("\n" + "-" * 20 + f" {message} " + "-" * 20, flush=True)
