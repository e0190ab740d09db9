"""Megatron-style GPT pretraining CLI for the PyTorch/CUDA port: the
counterpart of ``examples/gpt/pretrain_gpt.py`` on one device.

It takes the reference's Megatron flags with their defaults
(``apex_tpu/transformer/testing/arguments.py``) and its own
(``extra_flags``). The port has no mesh yet: a tensor-, pipeline- or
context-parallel size above 1, a virtual pipeline size,
``--sequence-parallel``, ``--use-distributed-optimizer`` and
``--gradient-accumulation-fusion`` stop the script with a message naming
ROADMAP queue A6. At data-parallel size 1 the reference's step is
``forward_backward_no_pipelining``: the global batch split into ``M =
global / micro`` microbatches, the loss the mean of the microbatch means,
the gradients summed in fp32 and divided by ``M``; then
``FusedAdam(lr=--lr, weight_decay=0.01)``.

The reference keeps the tied word table twice in its pipeline layout
(the lookup's copy and the logits head's) and adds the two gradients
into both with ``accumulate_tied_word_grads``, so both copies take the
same update. Here one table is tied by autograd: the lookup's and the
head's gradients add into its one gradient, and the single copy takes
that same update.

Weights come from ``PRNGKey(--seed)`` through the JAX package's
``init_gpt`` draws (``models.gpt.init_gpt_from_key``); step ``i``'s
batch is ``randint(PRNGKey(1000 + i), (global batch, seq), 0, vocab)``
with the labels the ids themselves, as in the reference. Runs on the
CUDA device by default, on the CPU with ``--device cpu``::

    python -m apex_tpu_torch.examples.gpt.pretrain_gpt --steps 10
"""

import argparse

import torch

from apex_tpu_torch.examples.gpt.train import (
    synthetic_batch, value_and_grad,
)
from apex_tpu_torch.models.gpt import (
    GPTConfig, gpt_loss_unsharded, init_gpt_from_key,
)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.platform import resolve_device
from apex_tpu_torch.utils.tree import tree_map


def extra_flags(p):
    g = p.add_argument_group("pretrain")
    g.add_argument("--steps", type=int, default=10)
    g.add_argument("--use-distributed-optimizer", action="store_true")
    g.add_argument("--gradient-accumulation-fusion", action="store_true",
                   help="per-layer fp32 wgrad emission in the TP linears "
                        "(Megatron --gradient-accumulation-fusion)")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's Megatron flags (``transformer.testing.arguments
    .parse_args``) and :func:`extra_flags`; unknown flags are tolerated,
    as there."""
    p = argparse.ArgumentParser(description="apex_tpu_torch GPT pretrain",
                                allow_abbrev=False)
    g = p.add_argument_group("parallelism")
    g.add_argument("--tensor-model-parallel-size", type=int, default=1)
    g.add_argument("--pipeline-model-parallel-size", type=int, default=1)
    g.add_argument("--virtual-pipeline-model-parallel-size", type=int,
                   default=None)
    g.add_argument("--context-parallel-size", type=int, default=1)
    g.add_argument("--sequence-parallel", action="store_true")
    g = p.add_argument_group("model")
    g.add_argument("--num-layers", type=int, default=4)
    g.add_argument("--hidden-size", type=int, default=64)
    g.add_argument("--num-attention-heads", type=int, default=8)
    g.add_argument("--seq-length", type=int, default=64)
    g.add_argument("--max-position-embeddings", type=int, default=64)
    g.add_argument("--padded-vocab-size", type=int, default=512)
    g = p.add_argument_group("training")
    g.add_argument("--micro-batch-size", type=int, default=2)
    g.add_argument("--global-batch-size", type=int, default=8)
    g.add_argument("--lr", type=float, default=1e-4)
    g.add_argument("--fp16", action="store_true")
    g.add_argument("--bf16", action="store_true")
    ns, _ = extra_flags(p).parse_known_args(argv)
    return ns


def _check_single_device(ns: argparse.Namespace) -> None:
    parallel = {
        "--tensor-model-parallel-size": ns.tensor_model_parallel_size > 1,
        "--pipeline-model-parallel-size":
            ns.pipeline_model_parallel_size > 1,
        "--virtual-pipeline-model-parallel-size":
            ns.virtual_pipeline_model_parallel_size is not None,
        "--context-parallel-size": ns.context_parallel_size > 1,
        "--sequence-parallel": ns.sequence_parallel,
        "--use-distributed-optimizer": ns.use_distributed_optimizer,
        "--gradient-accumulation-fusion": ns.gradient_accumulation_fusion,
    }
    asked = [flag for flag, on in parallel.items() if on]
    if asked:
        raise SystemExit(
            f"{', '.join(asked)}: the port runs one device; tensor, "
            "pipeline, context and data parallelism and the distributed "
            "optimizer are ROADMAP queue A6 (data and model parallelism)")


def main(argv=None) -> int:
    ns = parse_args(argv)
    _check_single_device(ns)
    dev = resolve_device(ns.device)
    print(f"mesh: dp=1 tp={ns.tensor_model_parallel_size} "
          f"pp={ns.pipeline_model_parallel_size}", flush=True)
    cfg = GPTConfig(
        vocab_size=ns.padded_vocab_size, hidden_size=ns.hidden_size,
        num_layers=ns.num_layers, num_heads=ns.num_attention_heads,
        ffn_hidden_size=4 * ns.hidden_size,
        max_position_embeddings=ns.max_position_embeddings)
    params = init_gpt_from_key(prng.PRNGKey(ns.seed), cfg, device=dev)
    opt = FusedAdam(lr=ns.lr, weight_decay=0.01)
    opt_state = opt.init(params)

    if ns.global_batch_size % ns.micro_batch_size:
        raise SystemExit(
            f"local batch {ns.global_batch_size} (global/dp) not divisible "
            f"by --micro-batch-size {ns.micro_batch_size} (Megatron errors "
            "here too; silent re-sizing would train a different config)")
    M = ns.global_batch_size // ns.micro_batch_size
    vg = value_and_grad(gpt_loss_unsharded)

    def train_step(p, ostate, ids):
        # forward_backward_no_pipelining: fp32 gradient accumulation
        # over the microbatches, the mean of their losses
        total, grads = 0.0, None
        for mb in ids.chunk(M):
            loss, g = vg(p, cfg, mb, mb)
            total = total + loss
            grads = g if grads is None else tree_map(torch.add, grads, g)
        grads = tree_map(lambda a: a / M, grads)
        p, ostate = opt.step(grads, p, ostate)
        return p, ostate, total / M

    b, s = ns.global_batch_size, ns.seq_length
    for i in range(ns.steps):
        ids = synthetic_batch(i, b, s, cfg.vocab_size, dev)
        params, opt_state, loss = train_step(params, opt_state, ids)
        if i % 2 == 0 or i == ns.steps - 1:
            print(f"step {i:3d}  loss {float(loss):.6f}", flush=True)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
