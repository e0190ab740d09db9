"""Megatron-style flag parsing (counterpart of
``apex_tpu/transformer/testing/arguments.py``; reference:
``apex/transformer/testing/arguments.py :: parse_args``): the trimmed
Megatron argument set, with the reference's flags and defaults. Unknown
flags are tolerated (``parse_known_args``), since reference-shaped
scripts pass a superset."""

import argparse
from typing import List, Optional


def parse_args(extra_args_provider=None,
               args: Optional[List[str]] = None,
               ignore_unknown_args: bool = True) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="apex_tpu transformer args",
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

    if extra_args_provider is not None:
        p = extra_args_provider(p)
    if ignore_unknown_args:
        ns, _ = p.parse_known_args(args)
    else:
        ns = p.parse_args(args)
    return ns


def initialize_from_args(ns: argparse.Namespace, device=None):
    """Build the global mesh from parsed flags (the ``initialize_megatron``
    step of reference test scripts); ``device`` brings up the default
    process group when none exists (``parallel_state``)."""
    from apex_tpu_torch.transformer import parallel_state as ps

    return ps.initialize_model_parallel(
        tensor_model_parallel_size_=ns.tensor_model_parallel_size,
        pipeline_model_parallel_size_=ns.pipeline_model_parallel_size,
        virtual_pipeline_model_parallel_size_=(
            ns.virtual_pipeline_model_parallel_size),
        context_parallel_size_=ns.context_parallel_size, device=device)
