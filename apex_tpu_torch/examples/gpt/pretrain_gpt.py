"""Megatron-style GPT pretraining CLI for the PyTorch/CUDA port: the
counterpart of ``examples/gpt/pretrain_gpt.py``, the whole parallel stack
in one script.

It takes the reference's Megatron flags with their defaults
(``transformer.testing.arguments``) and its own (``extra_flags``), then
follows the reference: the mesh from the flags (dp x tp x pp, printed as
``mesh: dp= tp= pp=``); the tensor-parallel ``GPTModel`` laid out by
``gpt_to_pipeline_params``; the schedule the flags select (no
pipelining at pp 1, 1F1B, interleaved with
``--virtual-pipeline-model-parallel-size``) over ``M = (global / dp) /
micro`` microbatches; the tied word table's two gradients summed by
``accumulate_tied_word_grads``; the sequence-parallel gradients
all-reduced; then ``FusedAdam(lr=--lr, weight_decay=0.01)`` on the
data-mean gradients, or with ``--use-distributed-optimizer``
``DistributedFusedAdam`` (ZeRO: the rank's own gradients in, the
reduce-scatter inside its step), which the reference refuses beside tp
or pp above 1. ``--context-parallel-size`` above 1 stops with the
reference's message.

Each rank runs the step on its blocks, as the reference's step runs
inside its ``shard_map``: the params and optimizer state are cut once
(``parallel_state.shard_map`` with the spec trees) and stay cut between
the steps (the script prints the loss only, so nothing is gathered
back).

The default process group: when none is up, a launcher's environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
``torchrun`` sets them) starts it by ``env://``, on NCCL on the card
(one rank a card, ``LOCAL_RANK``'s) or gloo on the CPU;
``--dist-backend gloo`` asks for gloo on the card (two ranks on one
card: NCCL refuses them). Without a launcher the script is a world of
one. A group the script started ends with it.

Weights come from ``PRNGKey(--seed)`` through the JAX package's
``init_gpt`` draws (``models.gpt.init_gpt_from_key``); step ``i``'s
batch is ``randint(PRNGKey(1000 + i), (global batch, seq), 0, vocab)``
with the labels the ids themselves, split over the data ranks. Runs on
the CUDA device by default, on the CPU with ``--device cpu``::

    python -m apex_tpu_torch.examples.gpt.pretrain_gpt --steps 10
    torchrun --nproc-per-node 2 -m apex_tpu_torch.examples.gpt.pretrain_gpt \\
        --pipeline-model-parallel-size 2 --dist-backend gloo
"""

import argparse
import os

import torch
import torch.distributed as dist

from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
from apex_tpu_torch.examples.gpt.train import synthetic_batch
from apex_tpu_torch.models.gpt import (
    GPTConfig, GPTModel, accumulate_tied_word_grads, gpt_pipeline_model,
    gpt_pipeline_partition_specs, gpt_to_pipeline_params, init_gpt_from_key,
)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    forward_backward_no_pipelining,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import collective
from apex_tpu_torch.transformer.testing import arguments
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.platform import resolve_device
from apex_tpu_torch.utils.tree import tree_map

P = ps.PartitionSpec


def extra_flags(p):
    g = p.add_argument_group("pretrain")
    g.add_argument("--steps", type=int, default=10)
    g.add_argument("--use-distributed-optimizer", action="store_true")
    g.add_argument("--gradient-accumulation-fusion", action="store_true",
                   help="per-layer fp32 wgrad emission in the TP linears "
                        "(Megatron --gradient-accumulation-fusion)")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--device", default=None, help="cuda (default) or cpu")
    g.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="the default process group's backend when the "
                        "script starts it from a launcher's environment "
                        "(nccl on the card, gloo on the CPU by default)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's Megatron flags (``transformer.testing.arguments
    .parse_args``) and :func:`extra_flags`; unknown flags are tolerated,
    as there."""
    return arguments.parse_args(extra_args_provider=extra_flags, args=argv)


def _start_group(ns: argparse.Namespace, dev: torch.device) -> bool:
    """Start the default process group from a launcher's environment
    when none is up; True where this call started it."""
    if dist.is_initialized() or not ("RANK" in os.environ
                                     and "WORLD_SIZE" in os.environ):
        return False
    backend = ns.dist_backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://")
    return True


class Pretrain:
    """The script's step on this rank, after the mesh: ``params`` and
    ``opt_state`` are this rank's blocks, ``batch(i)`` step i's data-rank
    block, ``loss_and_grads(params, batch)`` the schedule's loss and
    gradients (the tied word gradients summed, the sequence-parallel ones
    all-reduced, before any data mean), ``step(params, opt_state,
    batch)`` one whole step."""

    def __init__(self, ns: argparse.Namespace, dev: torch.device):
        tp_sz, pp = ns.tensor_model_parallel_size, \
            ns.pipeline_model_parallel_size
        self.ns, self.dev = ns, dev
        self.dp = dp = ps.get_data_parallel_world_size()
        self.cfg = cfg = GPTConfig(
            vocab_size=ns.padded_vocab_size, hidden_size=ns.hidden_size,
            num_layers=ns.num_layers, num_heads=ns.num_attention_heads,
            ffn_hidden_size=4 * ns.hidden_size,
            max_position_embeddings=ns.max_position_embeddings,
            sequence_parallel=ns.sequence_parallel,
            gradient_accumulation_fusion=ns.gradient_accumulation_fusion)
        vpp = ns.virtual_pipeline_model_parallel_size
        self.model = GPTModel(cfg, tp_size=tp_sz)
        params = init_gpt_from_key(prng.PRNGKey(ns.seed), cfg, device=dev)
        pipe_params = gpt_to_pipeline_params(params, cfg, pp, vpp)
        del params
        self.pipe_model = gpt_pipeline_model(self.model)
        pspecs = gpt_pipeline_partition_specs(cfg, vpp)

        self.zero = ns.use_distributed_optimizer
        if self.zero:
            if tp_sz > 1 or pp > 1:
                raise SystemExit(
                    "--use-distributed-optimizer composes with pure data "
                    "parallelism (the reference's DistributedFusedAdam is "
                    "likewise the MLPerf DDP-BERT tool): the ZeRO flat "
                    "layout is built from the full param tree, which inside "
                    "a tp/pp mesh no longer matches the rank-local shapes. "
                    "Drop --tensor/pipeline-model-parallel-size or use the "
                    "replicated FusedAdam.")
            self.opt = DistributedFusedAdam(lr=ns.lr, weight_decay=0.01)
            opt_state = self.opt.init(pipe_params)
            ospecs = self.opt.partition_spec()
        else:
            self.opt = FusedAdam(lr=ns.lr, weight_decay=0.01)
            opt_state = self.opt.init(pipe_params)
            ospecs = type(opt_state)(step=P(), m=pspecs, v=pspecs)

        # microbatches are per DATA rank: local batch = global / dp
        if ns.global_batch_size % dp:
            raise SystemExit(f"--global-batch-size {ns.global_batch_size} "
                             f"not divisible by dp {dp}")
        local_batch = ns.global_batch_size // dp
        if local_batch % ns.micro_batch_size:
            raise SystemExit(
                f"local batch {local_batch} (global/dp) not divisible by "
                f"--micro-batch-size {ns.micro_batch_size} (Megatron errors "
                "here too; silent re-sizing would train a different config)")
        self.M = local_batch // ns.micro_batch_size
        if pp > 1 and vpp:
            self.fwd_bwd = forward_backward_pipelining_with_interleaving
        elif pp > 1:
            self.fwd_bwd = forward_backward_pipelining_without_interleaving
        else:
            self.fwd_bwd = forward_backward_no_pipelining
        # this rank's blocks, cut once (out_specs P(): kept as they are)
        self.params, self.opt_state = ps.shard_map(
            lambda p, o: (p, o), in_specs=(pspecs, ospecs),
            out_specs=P())(pipe_params, opt_state)

    def batch(self, i: int):
        ns = self.ns
        ids = synthetic_batch(i, ns.global_batch_size, ns.seq_length,
                              self.cfg.vocab_size, self.dev)
        ids = ps.shard_leaf(ids, P(ps.DATA_AXIS))
        return {"input_ids": ids, "labels": ids}

    def _pmean_data(self, t):
        if self.dp == 1:
            return t
        mesh = ps.get_mesh()
        return collective("all_reduce", t, mesh.groups[ps.DATA_AXIS],
                          mesh.members(ps.DATA_AXIS)) / self.dp

    def loss_and_grads(self, p, batch):
        loss, grads = self.fwd_bwd(self.pipe_model, p, batch,
                                   num_microbatches=self.M)
        # the tied embedding: the pipeline layout holds the word table
        # twice (the lookup's and the head's); summing the two partial
        # gradients into both gives both copies the same update
        grads = accumulate_tied_word_grads(grads)
        # SP: the LN and Row-bias gradients are partials over the model
        # axis
        grads = self.model.allreduce_sequence_parallel_grads(grads)
        return loss, grads

    def step(self, p, ostate, batch):
        loss, grads = self.loss_and_grads(p, batch)
        loss = self._pmean_data(loss)
        if not self.zero:
            grads = tree_map(self._pmean_data, grads)
        # ZeRO takes the rank's own gradients: the reduce-scatter inside
        # its step sums and averages them
        p, ostate = self.opt.step(grads, p, ostate)
        return p, ostate, loss


def main(argv=None) -> int:
    ns = parse_args(argv)
    dev = resolve_device(ns.device)
    started = _start_group(ns, dev) or not dist.is_initialized()
    try:
        arguments.initialize_from_args(ns, device=dev)
        rank0 = dist.get_rank() == 0

        def say(text):
            if rank0:
                print(text, flush=True)

        say(f"mesh: dp={ps.get_data_parallel_world_size()} "
            f"tp={ns.tensor_model_parallel_size} "
            f"pp={ns.pipeline_model_parallel_size}")
        if ns.context_parallel_size > 1:
            raise SystemExit(
                "this script does not drive context parallelism — use "
                "transformer.context_parallel.ring_attention directly")
        run = Pretrain(ns, dev)
        p, o = run.params, run.opt_state
        for i in range(ns.steps):
            p, o, loss = run.step(p, o, run.batch(i))
            if i % 2 == 0 or i == ns.steps - 1:
                say(f"step {i:3d}  loss {float(loss):.6f}")
        say("DONE")
        if dist.get_world_size() > 1:
            dist.barrier()
        return 0
    finally:
        ps.destroy_model_parallel()
        if started and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
