"""Vocab-parallel cross entropy (counterpart of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``; reference:
``apex/transformer/tensor_parallel/cross_entropy.py ::
_VocabParallelCrossEntropy``).

The logits arrive split over the vocabulary (last) dimension, this
rank's block at its ``model`` index. The loss takes three all-reduces:
the maximum, the sum of the exponentials and the target's shifted logit
from the shard that owns it; the full softmax is never formed. The
backward is (softmax - one_hot) on each shard. Plain PyTorch ops in
fp32, as the JAX package computes it outside any kernel.
"""

import torch

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel.mappings import _all_reduce


class _VocabParallelCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target):
        x = logits.float()
        per_rank = x.shape[-1]
        start = ps.get_tensor_model_parallel_rank() * per_rank
        tp = ps.get_tensor_model_parallel_world_size() > 1
        lmax = x.amax(dim=-1)
        if tp:
            lmax = _all_reduce(lmax, "max")
        shifted = x - lmax[..., None]
        exp = torch.exp(shifted)
        sum_exp = exp.sum(dim=-1)
        local = target - start
        in_range = (local >= 0) & (local < per_rank)
        safe = torch.where(in_range, local, torch.zeros_like(local))
        tgt = shifted.gather(-1, safe[..., None].long())[..., 0]
        tgt = torch.where(in_range, tgt, torch.zeros_like(tgt))
        if tp:
            sum_exp = _all_reduce(sum_exp)
            tgt = _all_reduce(tgt)
        loss = torch.log(sum_exp) - tgt
        exp.div_(sum_exp[..., None])            # the local softmax
        ctx.save_for_backward(exp, in_range, safe)
        ctx.logits_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        softmax, in_range, safe = ctx.saved_tensors
        grad = softmax.clone()
        grad.scatter_add_(-1, safe[..., None].long(),
                          -in_range.to(grad.dtype)[..., None])
        grad.mul_(g[..., None])
        return grad.to(ctx.logits_dtype), None


def vocab_parallel_cross_entropy(logits, target):
    """Per-token loss (``target``'s shape) of logits split over the
    vocabulary dimension across the ``model`` axis."""
    return _VocabParallelCrossEntropy.apply(logits, target)
