"""Megatron tensor-parallel layers (counterpart of
``apex_tpu/transformer/tensor_parallel/layers.py``; reference:
``apex/transformer/tensor_parallel/layers.py``):
``ColumnParallelLinear`` (kernel split on its output dimension),
``RowParallelLinear`` (on its input dimension), ``VocabParallelEmbedding``
(a vocabulary range a rank, then an all-reduce), and
``linear_with_grad_accumulation``, the ``gradient_accumulation_fusion``
weight gradient.

Execution model, as in the JAX package: ``init`` builds the whole
(unsharded) params; ``apply`` runs inside ``parallel_state.shard_map``,
where each rank holds its block of them (``partition_specs()`` are the
``in_specs`` that cut it). The products are ``torch.matmul``, as the JAX
package's are plain ``jnp.dot``.

Sequence parallelism (``sequence_parallel_enabled``): outside the
tensor-parallel regions the activations are split along the sequence
dimension (``sequence_parallel_seq_dim``) over the same ``model`` axis;
Column all-gathers its input (backward: reduce-scatter), Row
reduce-scatters its output (backward: all-gather).
"""

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.utils.math import divide
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device

_AXIS = ps.TENSOR_AXIS
P = ps.PartitionSpec


def _init_kernel(generator, shape, dtype, device):
    """N(0, 1/fan_in) drawn on ``generator``'s device, then moved to
    ``device`` (the card by default)."""
    dev = resolve_device(device)
    fan_in = shape[0]
    x = torch.randn(shape, generator=generator, dtype=dtype,
                    device=generator.device) * math.sqrt(1.0 / fan_in)
    return x.to(dev)


def _fp32_product(a, b):
    """``a @ b`` of two tensors of any float dtype, accumulated and
    returned in fp32 (every product of two bf16 or fp32 values is exact
    in fp32: XLA's ``preferred_element_type=float32``)."""
    return torch.matmul(a.float(), b.float())


class _LinearGradAccumulation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return torch.matmul(x, kernel.to(x.dtype))

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        dx = _fp32_product(dy, kernel.to(dy.dtype).t()).to(x.dtype)
        dk = _fp32_product(x.reshape(-1, x.shape[-1]).t(),
                           dy.reshape(-1, dy.shape[-1])).to(kernel.dtype)
        return dx, dk


def linear_with_grad_accumulation(x, kernel):
    """``x @ kernel`` whose weight gradient leaves in the kernel's dtype,
    summed in fp32 with no round trip through the activations' dtype (the
    ``gradient_accumulation_fusion`` counterpart of the reference's
    ``fused_weight_gradient_mlp_cuda``): with fp32 master weights and
    bf16 activations, the plain product's weight gradient is rounded to
    bf16 before it meets an fp32 accumulator; this one is not. The input
    gradient too is summed in fp32, then cast to ``x``'s dtype."""
    return _LinearGradAccumulation.apply(x, kernel)


def _matmul(x, kernel, fused):
    if fused:
        return linear_with_grad_accumulation(x, kernel)
    return torch.matmul(x, kernel.to(x.dtype))


class ColumnParallelLinear:
    """Y = X A + b with A split by columns: A = [A_1 .. A_p].
    ``gather_output=True`` all-gathers Y (each rank then holds the whole
    output); otherwise Y stays split for a following
    ``RowParallelLinear``."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, gather_output: bool = True,
                 sequence_parallel_enabled: bool = False,
                 sequence_parallel_seq_dim: int = 0,
                 gradient_accumulation_fusion: bool = False,
                 params_dtype=torch.float32, tp_size: Optional[int] = None):
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = bias
        self.gather_output = gather_output
        self.gradient_accumulation_fusion = gradient_accumulation_fusion
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.sequence_parallel_seq_dim = sequence_parallel_seq_dim
        self.params_dtype = params_dtype
        if sequence_parallel_enabled and gather_output:
            raise ValueError(
                "sequence_parallel_enabled requires gather_output=False "
                "(the reference asserts the same)")
        tp = tp_size if tp_size is not None else \
            ps.get_tensor_model_parallel_world_size()
        divide(out_features, tp)

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> Dict[str, Any]:
        p = {"kernel": _init_kernel(
            generator, (self.in_features, self.out_features),
            self.params_dtype, device)}
        if self.use_bias:
            p["bias"] = torch.zeros((self.out_features,),
                                    dtype=self.params_dtype,
                                    device=p["kernel"].device)
        return p

    def partition_specs(self) -> Dict[str, Any]:
        s = {"kernel": P(None, _AXIS)}
        if self.use_bias:
            s["bias"] = P(_AXIS)
        return s

    def apply(self, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        if self.sequence_parallel_enabled:
            # x arrives split on the sequence: gather it for the product
            x = mappings.gather_from_sequence_parallel_region(
                x, True, self.sequence_parallel_seq_dim)
        else:
            # identity forward, all-reduce of dX backward
            x = mappings.copy_to_tensor_model_parallel_region(x)
        y = _matmul(x, params["kernel"], self.gradient_accumulation_fusion)
        if self.use_bias:
            y = y + params["bias"].to(y.dtype)
        if self.gather_output:
            y = mappings.gather_from_tensor_model_parallel_region(y)
        return y

    __call__ = apply


class RowParallelLinear:
    """Y = X A + b with A split by rows; X arrives split on its last
    dimension (``input_is_parallel``: a Column layer's output). The bias
    is added after the reduction, on every rank."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, input_is_parallel: bool = True,
                 sequence_parallel_enabled: bool = False,
                 sequence_parallel_seq_dim: int = 0,
                 gradient_accumulation_fusion: bool = False,
                 params_dtype=torch.float32, tp_size: Optional[int] = None):
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = bias
        self.input_is_parallel = input_is_parallel
        self.gradient_accumulation_fusion = gradient_accumulation_fusion
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.sequence_parallel_seq_dim = sequence_parallel_seq_dim
        self.params_dtype = params_dtype
        if sequence_parallel_enabled and not input_is_parallel:
            raise ValueError(
                "sequence_parallel_enabled requires input_is_parallel")
        tp = tp_size if tp_size is not None else \
            ps.get_tensor_model_parallel_world_size()
        divide(in_features, tp)

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> Dict[str, Any]:
        p = {"kernel": _init_kernel(
            generator, (self.in_features, self.out_features),
            self.params_dtype, device)}
        if self.use_bias:
            p["bias"] = torch.zeros((self.out_features,),
                                    dtype=self.params_dtype,
                                    device=p["kernel"].device)
        return p

    def partition_specs(self) -> Dict[str, Any]:
        s = {"kernel": P(_AXIS, None)}
        if self.use_bias:
            s["bias"] = P()
        return s

    def apply(self, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        if not self.input_is_parallel:
            x = mappings.scatter_to_tensor_model_parallel_region(x)
        y = _matmul(x, params["kernel"], self.gradient_accumulation_fusion)
        if self.sequence_parallel_enabled:
            y = mappings.reduce_scatter_to_sequence_parallel_region(
                y, self.sequence_parallel_seq_dim)
        else:
            y = mappings.reduce_from_tensor_model_parallel_region(y)
        if self.use_bias:
            y = y + params["bias"].to(y.dtype)
        return y

    __call__ = apply


class VocabParallelEmbedding:
    """An embedding whose vocabulary is split over the ``model`` axis:
    rank r owns rows [r V/p, (r+1) V/p); ids outside its range look up
    zeros, and the partial lookups are summed by an all-reduce."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 params_dtype=torch.float32, tp_size: Optional[int] = None):
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.params_dtype = params_dtype
        tp = tp_size if tp_size is not None else \
            ps.get_tensor_model_parallel_world_size()
        divide(num_embeddings, tp)

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> Dict[str, Any]:
        dev = resolve_device(device)
        x = torch.randn((self.num_embeddings, self.embedding_dim),
                        generator=generator, dtype=self.params_dtype,
                        device=generator.device) * 0.02
        return {"embedding": x.to(dev)}

    def partition_specs(self) -> Dict[str, Any]:
        return {"embedding": P(_AXIS, None)}

    def apply(self, params: Dict[str, Any],
              ids: torch.Tensor) -> torch.Tensor:
        table = params["embedding"]          # this rank's (V/p, H) block
        per_rank = table.shape[0]
        start = ps.get_tensor_model_parallel_rank() * per_rank
        local = ids - start
        in_range = (local >= 0) & (local < per_rank)
        safe = torch.where(in_range, local, torch.zeros_like(local))
        out = F.embedding(safe, table)
        out = torch.where(in_range[..., None], out, torch.zeros_like(out))
        return mappings.reduce_from_tensor_model_parallel_region(out)

    __call__ = apply
