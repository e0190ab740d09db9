"""BERT masked-LM training steps under amp O2 for the PyTorch/CUDA port:
the counterpart of the JAX benchmark's ``bench.py::_bert_step``.

One step: ``amp.initialize("O2", loss_scale="dynamic")`` casts the fp32
master tree (bf16 but the LayerNorm leaves), ``Amp.value_and_grad``
takes the scaled loss's gradients through the LayerNorm, flash-attention
and softmax-cross-entropy kernels, unscales them and advances the
dynamic loss scaler, and ``FusedAdam(lr=1e-4, weight_decay=0.01)`` (or
``FusedLAMB(lr=1e-3, weight_decay=0.01)``, the JAX package's BERT-Large
LAMB setting, ``bench.py::_make_optimizer``) steps the master tree,
skipping the step on an overflow. Two optimizer state modes, as the JAX
headline races them: ``fp32`` and ``bf16m_castout`` (bf16 first
moment, plus the updated params emitted in the compute dtypes and fed
back through ``cast_model(precast=...)``). Switches of the JAX package
pick the configuration: the model config's ``fused_attention`` (flash
attention, or the score product, the fused softmax and the context
product), the optimizer, and its ``use_flat_kernel`` (the tree path, or
packed buffers stepped by one ``flat_adam`` kernel, or by LAMB's
grad-norm pre-pass and stage-1 kernels); the defaults are flash
attention and the tree-path FusedAdam. With a ``dropout_rng`` (a
``utils.prng`` key) step ``i`` runs the model's hidden and attention
dropout on ``fold_in(dropout_rng, i)``; without one the step is the JAX
benchmark's, which runs none.

Data parallelism (the JAX ``bench.py::bench_ddp_bert``, ``BASELINE.json``
config #4): with a ``parallel.DistributedDataParallel``, each rank takes
its slice of the global batch, the master tree is broadcast from rank 0
once (in ``make_state``), and ``allreduce_grads`` averages the gradients
over the data group between ``grads()`` and the optimizer step; each
rank takes ``found_inf`` from its own gradients, before the all-reduce,
as the reference does. At one rank it is the plain step's numbers. The
CLI takes the world from the process group, which a launcher's
environment brings up::

    torchrun --nproc_per_node 4 -m apex_tpu_torch.examples.bert.train \
        --batch 256

Random weights from a seed and one fixed batch of random ids (every
position predicted). Runs on the CUDA device by default::

    python -m apex_tpu_torch.examples.bert.train --config large --steps 4
    python -m apex_tpu_torch.examples.bert.train --attention softmax \
        --flat-kernel
    python -m apex_tpu_torch.examples.bert.train --optimizer lamb \
        --flat-kernel
    python -m apex_tpu_torch.examples.bert.train --dropout-seed 0

and on the CPU (the kernels' plain versions) with ``--device cpu``::

    python -m apex_tpu_torch.examples.bert.train --config tiny \\
        --batch 2 --seq 16 --device cpu
"""

import argparse
import dataclasses
import os
import statistics
import time
from typing import Any, Optional, Tuple, Union

import torch
import torch.distributed as dist

from apex_tpu_torch import amp
from apex_tpu_torch.models.bert import (
    BertConfig, apply_bert, bert_base, bert_large, bert_tiny, init_bert,
    mlm_loss,
)
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from apex_tpu_torch.parallel import DistributedDataParallel
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device

CONFIGS = {"tiny": bert_tiny, "base": bert_base, "large": bert_large}
STATE_MODES = {"fp32": (torch.float32, False),
               "bf16m_castout": (torch.bfloat16, True)}
# the JAX package's BERT-Large settings (bench.py: _bert_step, and
# _make_optimizer for LAMB); every other argument keeps its default
OPTIMIZERS = {"adam": (FusedAdam, 1e-4), "lamb": (FusedLAMB, 1e-3)}


class BertTrainStep:
    """``step(master, opt_state, scaler_state, [compute,] ids, mask)``
    returns ``(master, opt_state, scaler_state, [compute,] loss)``, the
    JAX ``train_step``'s tuple; :meth:`grads` is its first half. With
    ``dropout_rng``, the ``steps``-th call draws its dropout on
    ``fold_in(dropout_rng, steps)``. With ``ddp``, the gradients are
    all-reduced between :meth:`grads` and the optimizer step, and the
    loss returned is the mean over the data group."""

    def __init__(self, cfg: BertConfig, handle: amp.Amp,
                 opt: Union[FusedAdam, FusedLAMB], dropout_rng=None,
                 ddp: Optional[DistributedDataParallel] = None):
        self.cfg = cfg
        self.amp = handle
        self.opt = opt
        self.dropout_rng = dropout_rng
        self.ddp = ddp
        self.steps = 0
        self._value_and_grad = handle.value_and_grad(self.loss_fn)

    def loss_fn(self, p, ids, mask, dropout_rng=None):
        out = apply_bert(p, self.cfg, ids, mask, dropout_rng=dropout_rng)
        return mlm_loss(out["mlm_logits"], ids, mask)

    def grads(self, master, scaler_state, ids, mask,
              compute: Optional[Any] = None, dropout_rng=None):
        """(compute tree p, loss, grads, found_inf, new scaler state);
        ``dropout_rng`` is the model's key as it is (no ``fold_in``)."""
        p = self.amp.cast_model(master, precast=compute)
        loss, grads, found_inf, scaler_state = self._value_and_grad(
            p, scaler_state, ids, mask, dropout_rng=dropout_rng)
        return p, loss, grads, found_inf, scaler_state

    def __call__(self, master, opt_state, scaler_state, *rest):
        *compute, ids, mask = rest
        rng = None if self.dropout_rng is None else prng.fold_in(
            self.dropout_rng, self.steps)
        self.steps += 1
        p, loss, grads, found_inf, scaler_state = self.grads(
            master, scaler_state, ids, mask,
            compute[0] if compute else None, dropout_rng=rng)
        if self.ddp is not None:
            grads = self.ddp.allreduce_grads(grads)
            group, size = ps.axis_group(self.ddp.axis_name)
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=group)
            loss = loss / size
        if self.opt.emit_compute_params:
            master, opt_state, c = self.opt.step(
                grads, master, opt_state, found_inf=found_inf,
                compute_params=p)
            return master, opt_state, scaler_state, c, loss
        master, opt_state = self.opt.step(grads, master, opt_state,
                                          found_inf=found_inf)
        return master, opt_state, scaler_state, loss


def make_bert_train_step(batch: int, seq: int, cfg: BertConfig, *,
                         m_dtype: torch.dtype = torch.float32,
                         emit_compute: bool = False,
                         device: DeviceLike = None, opt_level: str = "O2",
                         seed: int = 0, use_flat_kernel: bool = False,
                         optimizer: str = "adam", dropout_rng=None,
                         ddp: Optional[DistributedDataParallel] = None
                         ) -> Tuple[BertTrainStep, Any, Tuple]:
    """Returns ``(train_step, make_state, (ids, mask))`` as the JAX
    ``_bert_step`` does; ``cfg.fused_attention``, ``optimizer``
    (``"adam"``: ``FusedAdam(lr=1e-4)``; ``"lamb"``: ``FusedLAMB(lr=
    1e-3)``; both with weight decay 0.01) and ``use_flat_kernel`` pick
    the configuration; ``dropout_rng`` turns the model's dropout on
    (``BertTrainStep``).
    ``make_state()`` draws the fp32 master tree
    from ``seed`` (on a generator on ``device``) and returns ``(master,
    opt_state, scaler_state)``, plus the compute tree with
    ``emit_compute``. ``ids`` come from a CPU generator seeded 1, so they
    are the same on every device; ``mask`` is all ones. With ``ddp``,
    ``batch`` is the global batch: ``(ids, mask)`` are this rank's slice
    of it, and ``make_state`` broadcasts the master tree from rank 0."""
    dev = resolve_device(device)
    h = amp.initialize(opt_level, loss_scale="dynamic", verbosity=0)
    cls, lr = OPTIMIZERS[optimizer]
    opt = cls(lr=lr, weight_decay=0.01, m_dtype=m_dtype,
              emit_compute_params=emit_compute,
              use_flat_kernel=use_flat_kernel)

    def make_state():
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_bert(cfg, gen, device=dev)
        if ddp is not None:
            params = ddp.broadcast_params(params)
        base = (params, opt.init(params), h.init_state(dev))
        if not emit_compute:
            return base
        return base + (h.cast_model(params),)

    ids = torch.randint(0, cfg.vocab_size, (batch, seq),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    mask = torch.ones((batch, seq), dtype=torch.int32, device=dev)
    if ddp is not None:
        ids, mask = ddp.shard_batch((ids, mask))
    return (BertTrainStep(cfg, h, opt, dropout_rng, ddp), make_state,
            (ids, mask))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", choices=sorted(CONFIGS), default="large")
    p.add_argument("--batch", type=int, default=64,
                   help="the global batch (split over the data ranks "
                   "under a launcher)")
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--state-mode", choices=sorted(STATE_MODES),
                   default="fp32")
    p.add_argument("--attention", choices=("flash", "softmax"),
                   default="flash",
                   help="flash attention (fused_attention=True) or the "
                   "fused softmax between plain products")
    p.add_argument("--optimizer", choices=sorted(OPTIMIZERS),
                   default="adam")
    p.add_argument("--flat-kernel", action="store_true",
                   help="use_flat_kernel=True: the optimizer steps packed "
                   "buffers through its flat kernels")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dropout-seed", type=int, default=None,
                   help="run the model's dropout (0.1) on keys from "
                   "PRNGKey(dropout seed); off without it, as in the JAX "
                   "benchmark's step")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(CONFIGS[args.config](),
                              fused_attention=args.attention == "flash")
    m_dtype, emit = STATE_MODES[args.state_mode]
    ddp = None
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", 1)) > 1:
        ps.initialize_model_parallel(device=dev)
        ddp = DistributedDataParallel()
    rank0 = ddp is None or dist.get_rank() == 0
    step, make_state, (ids, mask) = make_bert_train_step(
        args.batch, args.seq, cfg, m_dtype=m_dtype, emit_compute=emit,
        device=dev, seed=args.seed, use_flat_kernel=args.flat_kernel,
        optimizer=args.optimizer,
        dropout_rng=None if args.dropout_seed is None
        else prng.PRNGKey(args.dropout_seed), ddp=ddp)
    state = make_state()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times = []
    for i in range(args.steps):
        sync()
        t0 = time.perf_counter()
        *state, loss = step(*state, ids, mask)
        sync()
        times.append(time.perf_counter() - t0)
        scaler = state[2]
        if rank0:
            print(f"step {i}: loss {float(loss):.5f}, loss scale "
                  f"{float(scaler.loss_scale):g}, unskipped "
                  f"{int(scaler.unskipped)}, {times[-1] * 1e3:.1f} ms",
                  flush=True)
    # the first step carries the warm-up (library handles, allocator)
    med = statistics.median(times[1:] or times)
    over = f"steps 2-{len(times)}" if len(times) > 1 else "one step"
    dp = "" if ddp is None else f" over {ps.get_data_parallel_world_size()} " \
        "data ranks"
    if rank0:
        print(f"bert {args.config} batch {args.batch}{dp} seq {args.seq} "
              f"{args.state_mode}, {args.attention} attention, "
              f"{'flat' if args.flat_kernel else 'tree'} "
              f"{type(step.opt).__name__} on {dev}: "
              f"median step {med * 1e3:.1f} ms "
              f"over {over}, {args.batch / med:.1f} samples/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
