"""GPT training steps for the PyTorch/CUDA port: the counterpart of the
JAX package's single-device GPT step, ``gpt_tp_bench(on_tpu,
n_devices=1)`` (``apex_tpu/models/gpt.py``), as a module and a CLI.

One step is that function's ``body1``: the gradients of
``gpt_loss_unsharded(compute_dtype=bfloat16)`` over the fp32 params
(the word table tied by autograd: the lookup and the logits product add
into one gradient), then ``FusedAdam(lr=1e-4, weight_decay=0.01)``
steps the params. ``gpt_medium()`` checkpoints every layer
(``remat=True``). With a ``dropout_rng`` (a ``utils.prng`` key) step
``i`` runs the hidden dropout on ``fold_in(dropout_rng, i)``; without
one the step is the JAX benchmark's, which runs none.
``make_gpt_tp_train_step`` is the same step at tp > 1 (that function's
``body``): ``GPTModel.loss`` inside ``parallel_state.shard_map`` over the
installed mesh's ``model`` axis, one process a rank.

Random weights from a seed and one fixed batch of ids from
``randint(PRNGKey(1000), (batch, seq), 0, vocab)``, the labels the ids
themselves (the reference CLI's synthetic data). Runs on the CUDA device
by default::

    python -m apex_tpu_torch.examples.gpt.train --config medium --steps 4
    python -m apex_tpu_torch.examples.gpt.train --use-rope \\
        --dropout-seed 0 --flat-kernel

and on the CPU (the kernels' plain versions) with ``--device cpu``::

    python -m apex_tpu_torch.examples.gpt.train --config tiny --batch 2 \\
        --seq 32 --device cpu
"""

import argparse
import dataclasses
import functools
import statistics
import time
from typing import Any, Callable, Optional, Tuple

import torch

from apex_tpu_torch.models.gpt import (
    GPTConfig, GPTModel, gpt_loss_unsharded, gpt_medium, gpt_tiny, init_gpt,
)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device
from apex_tpu_torch.utils.tree import tree_leaves, tree_map

CONFIGS = {"tiny": gpt_tiny, "medium": gpt_medium}


def synthetic_batch(i: int, batch: int, seq: int, vocab: int,
                    device: DeviceLike = None) -> torch.Tensor:
    """Step ``i``'s ids, ``randint(PRNGKey(1000 + i), (batch, seq), 0,
    vocab)`` as the reference CLI draws them (int64 for the lookup)."""
    return prng.randint(prng.PRNGKey(1000 + i), (batch, seq), 0, vocab,
                        device=device).long()


def value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, *args, **kw) -> (loss, grads)``: the gradients of
    ``loss_fn`` with respect to the floating leaves of ``params``, a
    tree like it (zeros where the loss does not reach), as
    ``jax.value_and_grad`` gives them."""

    def wrapped(params, *args, **kw):
        p = tree_map(lambda x: x.detach().requires_grad_(True)
                     if x.is_floating_point() else x, params)
        xs = [x for x in tree_leaves(p) if x.requires_grad]
        with torch.enable_grad():
            loss = loss_fn(p, *args, **kw)
            gs = torch.autograd.grad(loss, xs, allow_unused=True)
        by_id = {id(x): torch.zeros_like(x) if g is None else g
                 for x, g in zip(xs, gs)}
        return loss.detach(), tree_map(lambda x: by_id.get(id(x), x), p)

    return wrapped


class GPTTrainStep:
    """``step(params, opt_state, ids, labels) -> (params, opt_state,
    loss)``; :meth:`grads` is its first half. With ``dropout_rng`` the
    ``steps``-th call draws its dropout on ``fold_in(dropout_rng,
    steps)``."""

    def __init__(self, cfg: GPTConfig, opt: FusedAdam,
                 compute_dtype: Optional[torch.dtype], dropout_rng=None):
        self.cfg = cfg
        self.opt = opt
        self.compute_dtype = compute_dtype
        self.dropout_rng = dropout_rng
        self.steps = 0
        self._value_and_grad = value_and_grad(gpt_loss_unsharded)

    def grads(self, params, ids, labels, dropout_rng=None):
        """(loss, grads); ``dropout_rng`` is the model's key as it is (no
        ``fold_in``)."""
        return self._value_and_grad(params, self.cfg, ids, labels,
                                    dropout_rng=dropout_rng,
                                    compute_dtype=self.compute_dtype)

    def __call__(self, params, opt_state, ids, labels):
        rng = None if self.dropout_rng is None else prng.fold_in(
            self.dropout_rng, self.steps)
        self.steps += 1
        loss, grads = self.grads(params, ids, labels, dropout_rng=rng)
        params, opt_state = self.opt.step(grads, params, opt_state)
        return params, opt_state, loss


def make_gpt_train_step(cfg: GPTConfig, opt: Optional[FusedAdam] = None,
                        compute_dtype: Optional[torch.dtype] =
                        torch.bfloat16, dropout_rng=None
                        ) -> GPTTrainStep:
    """The JAX ``gpt_tp_bench(…, n_devices=1)`` step: ``opt`` defaults
    to its ``FusedAdam(lr=1e-4, weight_decay=0.01)`` on the tree path,
    ``compute_dtype`` to its bf16 over fp32 params (None: fp32
    compute)."""
    if opt is None:
        opt = FusedAdam(lr=1e-4, weight_decay=0.01)
    return GPTTrainStep(cfg, opt, compute_dtype, dropout_rng)


class GPTTPTrainStep(GPTTrainStep):
    """The tensor-parallel step of ``gpt_tp_bench(…, n_devices > 1)``, in
    this rank's process: ``GPTModel.loss`` and its gradients inside
    ``parallel_state.shard_map(in_specs=(specs, P(), P()),
    out_specs=(P(), specs))`` (the sequence-parallel gradients
    all-reduced before they leave it), so :meth:`grads` hands back the
    whole gradients; the optimizer then steps the whole params, the same
    on every rank."""

    def __init__(self, model: GPTModel, opt: FusedAdam,
                 compute_dtype: Optional[torch.dtype], dropout_rng=None):
        super().__init__(model.cfg, opt, compute_dtype, dropout_rng)
        self.model = model
        self.specs = model.partition_specs()
        vg = value_and_grad(model.loss)

        def loss_and_grads(params, ids, labels, dropout_rng=None):
            loss, grads = vg(params, ids, labels, dropout_rng=dropout_rng,
                             compute_dtype=compute_dtype)
            return loss, model.allreduce_sequence_parallel_grads(grads)

        self._loss_and_grads = loss_and_grads

    def grads(self, params, ids, labels, dropout_rng=None):
        """(loss, whole grads); ``dropout_rng`` the model's key as it
        is."""
        P = ps.PartitionSpec
        return ps.shard_map(
            functools.partial(self._loss_and_grads, dropout_rng=dropout_rng),
            in_specs=(self.specs, P(), P()),
            out_specs=(P(), self.specs))(params, ids, labels)


def make_gpt_tp_train_step(model: GPTModel, opt: Optional[FusedAdam] = None,
                           compute_dtype: Optional[torch.dtype] =
                           torch.bfloat16, dropout_rng=None
                           ) -> GPTTPTrainStep:
    """The JAX ``gpt_tp_bench(…, n_devices > 1)`` step over ``model``'s
    tensor-parallel layers (call with the mesh installed): ``opt``
    defaults to its ``FusedAdam(lr=1e-4, weight_decay=0.01)``,
    ``compute_dtype`` to bf16 over fp32 params."""
    if opt is None:
        opt = FusedAdam(lr=1e-4, weight_decay=0.01)
    return GPTTPTrainStep(model, opt, compute_dtype, dropout_rng)


def make_state(cfg: GPTConfig, opt: FusedAdam, seed: int = 0,
               device: DeviceLike = None) -> Tuple[Any, Any]:
    """(fp32 params from ``seed`` on a generator on ``device``, the
    optimizer's zeroed state)."""
    dev = resolve_device(device)
    params = init_gpt(cfg, torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    return params, opt.init(params)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", choices=sorted(CONFIGS), default="medium")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--flat-kernel", action="store_true",
                   help="use_flat_kernel=True: FusedAdam steps one packed "
                   "buffer through its flat kernel")
    p.add_argument("--use-rope", action="store_true",
                   help="rotary positions in place of the learned table")
    p.add_argument("--dropout-seed", type=int, default=None,
                   help="run the hidden dropout (0.1) on keys from "
                   "PRNGKey(dropout seed); off without it, as in the JAX "
                   "benchmark's step")
    p.add_argument("--no-remat", action="store_true",
                   help="keep every layer's activations (remat=False)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = CONFIGS[args.config]()
    cfg = dataclasses.replace(cfg, use_rope=args.use_rope,
                              remat=cfg.remat and not args.no_remat)
    step = make_gpt_train_step(
        cfg, FusedAdam(lr=1e-4, weight_decay=0.01,
                       use_flat_kernel=args.flat_kernel),
        dropout_rng=None if args.dropout_seed is None
        else prng.PRNGKey(args.dropout_seed))
    params, opt_state = make_state(cfg, step.opt, args.seed, dev)
    ids = synthetic_batch(0, args.batch, args.seq, cfg.vocab_size, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times = []
    for i in range(args.steps):
        sync()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, ids, ids)
        sync()
        times.append(time.perf_counter() - t0)
        print(f"step {i}: loss {float(loss):.5f}, {times[-1] * 1e3:.1f} ms",
              flush=True)
    # the first step carries the warm-up (library handles, allocator)
    med = statistics.median(times[1:] or times)
    over = f"steps 2-{len(times)}" if len(times) > 1 else "one step"
    print(f"gpt {args.config} batch {args.batch} seq {args.seq}, "
          f"{'rope' if cfg.use_rope else 'learned positions'}, remat "
          f"{cfg.remat}, {'flat' if args.flat_kernel else 'tree'} FusedAdam"
          f" on {dev}: median step {med * 1e3:.1f} ms over {over}, "
          f"{args.batch * args.seq / med:.0f} tokens/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
