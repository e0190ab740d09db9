"""Random keys and activation checkpointing for model parallelism
(counterpart of ``apex_tpu/transformer/tensor_parallel/random.py``;
reference: ``apex/transformer/tensor_parallel/random.py``).

The reference keeps CUDA RNG streams in a tracker so dropout inside
tensor-parallel regions differs per rank while replicated regions agree.
The JAX package, and this port, derive keys instead (``utils.prng``'s
threefry keys, bit for bit the JAX package's):

- ``model_parallel_rng_key(key)`` folds in this rank's ``model`` index
  (ranks that hold different tokens draw different masks);
- ``data_parallel_rng_key(key)`` folds in nothing (replicated regions
  agree by construction).

``checkpoint`` is ``torch.utils.checkpoint.checkpoint`` without
re-entry: the recompute replays the same keys, which are values.
"""

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils import prng

_MODEL_PARALLEL_RNG = "model-parallel-rng"  # tracker name in the reference


def model_parallel_rng_key(key: torch.Tensor) -> torch.Tensor:
    """Per-rank key: ``fold_in(key, model rank)`` (ref:
    ``get_cuda_rng_tracker().fork()``)."""
    return prng.fold_in(key, ps.get_tensor_model_parallel_rank())


def data_parallel_rng_key(key: torch.Tensor) -> torch.Tensor:
    """The key shared by all tensor-parallel ranks (the reference's
    default stream)."""
    return key


def model_parallel_seed(seed: int) -> dict:
    """Mirror of ``model_parallel_cuda_manual_seed(seed)``: the two base
    keys the reference derives (data-parallel seed, model-parallel seed
    offset by 2718)."""
    return {
        "data_parallel": prng.PRNGKey(seed),
        "model_parallel": prng.PRNGKey(seed + 2718),
    }


class RNGStatesTracker:
    """The reference's ``CudaRNGStatesTracker`` as key bookkeeping:
    ``fork(name)`` returns a derived key, not a context manager."""

    def __init__(self):
        self._keys = {}

    def add(self, name: str, seed: int) -> None:
        self._keys[name] = prng.PRNGKey(seed)

    def get_states(self) -> dict:
        return dict(self._keys)

    def set_states(self, states: dict) -> None:
        self._keys = dict(states)

    def reset(self) -> None:
        self._keys = {}

    def fork(self, name: str = _MODEL_PARALLEL_RNG) -> torch.Tensor:
        """Split off a fresh key; the tracker keeps the other half. Apply
        ``model_parallel_rng_key`` to it to decorrelate the ranks."""
        self._keys[name], sub = prng.split(self._keys[name])
        return sub


_TRACKER = RNGStatesTracker()


def get_rng_tracker() -> RNGStatesTracker:
    """ref: ``get_cuda_rng_tracker`` (renamed: nothing CUDA about it)."""
    return _TRACKER


def checkpoint(function, *args, policy=None, **kwargs):
    """``function(*args)`` with its activations recomputed in the
    backward (``torch.utils.checkpoint.checkpoint(use_reentrant=False)``);
    ``policy`` a :func:`checkpoint_policy` (None recomputes
    everything)."""
    if policy is not None:
        kwargs["context_fn"] = policy
    return _torch_checkpoint(function, *args, use_reentrant=False, **kwargs)


def checkpoint_policy(save_dots: bool = False):
    """The recompute policy for :func:`checkpoint`: ``save_dots`` keeps
    the 2-D matrix products' outputs (JAX's
    ``dots_with_no_batch_dims_saveable``), otherwise None, nothing kept
    (``nothing_saveable``)."""
    from apex_tpu_torch.models.gpt import _remat_context

    return _remat_context("dots_with_no_batch_dims_saveable" if save_dots
                          else "nothing_saveable")
