"""ImageNet-style ResNet training for the PyTorch/CUDA port: the
counterpart of the JAX package's ``examples/imagenet/main_amp.py``, with
its arguments, defaults and synthetic data shape (lr 0.1, momentum 0.9,
weight decay 1e-4; 224 x 224 images, 1000 classes).

One step, as the JAX ``train_step`` builds it: ``Amp.cast_model`` on the
fp32 master tree, ``Amp.cast_input`` on the images,
``Amp.value_and_grad(has_aux=True)`` over ``apply_resnet`` ->
``cross_entropy_loss`` (the new BatchNorm statistics are the aux), then
``FusedSGD.step(found_inf=...)`` and ``apply_if_finite`` on the
statistics (a skipped step keeps the old ones). ``--flat-kernel`` sets
the JAX constructor's ``use_flat_kernel=True``: the momentum buffer lives
as one packed buffer and one ``flat_sgd`` kernel a step updates it and
the params. Three configurations (``CONFIGS``): ``resnet_tree_o0`` (the
JAX example's defaults; the tree-path FusedSGD runs no kernel),
``resnet_flat_o0`` and ``resnet_flat_o2`` (``--opt-level O2``: bf16
convolutions, fp32 BatchNorm leaves, the dynamic loss scale).

Synthetic data: step i draws its images and labels from a CPU
``torch.Generator`` seeded 1000 + i (the JAX example draws
``jax.random`` bits, which the port does not reproduce yet). Left out
until ``utils/checkpoint.py`` is ported: ``--checkpoint``, ``--save-freq``
and ``--resume``. Runs on the CUDA device by default::

    python -m apex_tpu_torch.examples.imagenet.main_amp -a resnet50 -b 64 \\
        --opt-level O0 [--flat-kernel]

and on the CPU (the kernels' plain versions) with ``--device cpu``::

    python -m apex_tpu_torch.examples.imagenet.main_amp --device cpu \\
        -a resnet10 -b 2 --image-size 32 --steps 3
"""

import argparse
import time
from typing import Any, Optional, Tuple, Union

import torch

from apex_tpu_torch import amp
from apex_tpu_torch.models.resnet import (
    apply_resnet, cross_entropy_loss, init_resnet,
)
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.metrics import AverageMeter, Throughput
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device

# name -> (opt level, FusedSGD's use_flat_kernel)
CONFIGS = {"resnet_tree_o0": ("O0", False),
           "resnet_flat_o0": ("O0", True),
           "resnet_flat_o2": ("O2", True)}
LR, MOMENTUM, WEIGHT_DECAY = 0.1, 0.9, 1e-4   # the JAX example's defaults


class ResNetTrainStep:
    """``step(master, bn_stats, opt_state, scaler_state, images, labels)``
    returns ``(master, bn_stats, opt_state, scaler_state, loss)``, the
    JAX ``train_step``'s tuple; :meth:`grads` is its first half."""

    def __init__(self, depth: int, handle: amp.Amp, opt: FusedSGD):
        self.depth = depth
        self.amp = handle
        self.opt = opt
        self._value_and_grad = handle.value_and_grad(self.loss_fn,
                                                     has_aux=True)

    def loss_fn(self, p, stats, images, labels):
        logits, new_stats = apply_resnet(p, stats, images, self.depth,
                                         train=True)
        return cross_entropy_loss(logits, labels), new_stats

    def init_state(self, params: Any, stats: Any, device: DeviceLike = None
                   ) -> Tuple[Any, Any, Any, Any]:
        """``(master, bn_stats, opt_state, scaler_state)`` for fp32
        ``params`` and their statistics."""
        return params, stats, self.opt.init(params), \
            self.amp.init_state(device)

    def grads(self, master, bn_stats, scaler_state, images, labels):
        """(loss, new bn_stats, grads, found_inf, new scaler state)."""
        p = self.amp.cast_model(master)
        images = self.amp.cast_input(images)
        (loss, new_stats), grads, found_inf, scaler_state = \
            self._value_and_grad(p, scaler_state, bn_stats, images, labels)
        return loss, new_stats, grads, found_inf, scaler_state

    def __call__(self, master, bn_stats, opt_state, scaler_state, images,
                 labels):
        loss, new_stats, grads, found_inf, scaler_state = self.grads(
            master, bn_stats, scaler_state, images, labels)
        master, opt_state = self.opt.step(grads, master, opt_state,
                                          found_inf=found_inf)
        # a skipped step keeps the old statistics too
        new_stats = amp.apply_if_finite(new_stats, bn_stats, found_inf)
        return master, new_stats, opt_state, scaler_state, loss


def make_resnet_train_step(depth: int = 50, opt_level: str = "O0",
                           loss_scale: Union[None, str, float] = None,
                           keep_batchnorm_fp32: Optional[bool] = None,
                           optimizer: Optional[FusedSGD] = None
                           ) -> ResNetTrainStep:
    """The JAX example's step for ResNet-``depth``: ``amp.initialize(
    opt_level, loss_scale=..., keep_batchnorm_fp32=...)`` (None keeps the
    opt level's default) and ``optimizer``, by default the example's
    ``FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)``."""
    h = amp.initialize(opt_level, loss_scale=loss_scale,
                       keep_batchnorm_fp32=keep_batchnorm_fp32, verbosity=0)
    opt = optimizer if optimizer is not None else FusedSGD(
        lr=LR, momentum=MOMENTUM, weight_decay=WEIGHT_DECAY)
    return ResNetTrainStep(depth, h, opt)


def synthetic_batch(i: int, batch: int, image_size: int, num_classes: int,
                    device: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step ``i``'s images (N, H, W, 3) and int64 labels, drawn on
    ``device`` from ``PRNGKey(1000 + i)`` as the JAX example draws them
    (``normal`` and ``randint`` on the same key): the labels are the JAX
    example's exactly, the images within ``prng.normal_limit``."""
    key = prng.PRNGKey(1000 + i)
    images = prng.normal(key, (batch, image_size, image_size, 3),
                         device=device)
    labels = prng.randint(key, (batch,), 0, num_classes, device=device)
    return images, labels.to(torch.int64)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", "-a", default="resnet50",
                   choices=["resnet10", "resnet18", "resnet34", "resnet50"])
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=LR)
    p.add_argument("--momentum", type=float, default=MOMENTUM)
    p.add_argument("--weight-decay", type=float, default=WEIGHT_DECAY)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--opt-level", default="O0",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--keep-batchnorm-fp32", default=None)
    p.add_argument("--loss-scale", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--flat-kernel", action="store_true",
                   help="use_flat_kernel=True: FusedSGD steps one packed "
                   "buffer through the flat_sgd kernel")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    depth = int(args.arch.replace("resnet", ""))
    loss_scale = args.loss_scale
    if loss_scale not in (None, "dynamic"):
        loss_scale = float(loss_scale)
    kbn = args.keep_batchnorm_fp32
    if isinstance(kbn, str):
        kbn = kbn.lower() in ("1", "true", "yes")
    opt = FusedSGD(lr=args.lr, momentum=args.momentum,
                   weight_decay=args.weight_decay,
                   use_flat_kernel=args.flat_kernel)
    step = make_resnet_train_step(depth, args.opt_level, loss_scale, kbn,
                                  opt)
    params, stats = init_resnet(
        torch.Generator(device=dev).manual_seed(args.seed), depth,
        args.num_classes, device=dev)
    master, stats, opt_state, scaler_state = step.init_state(params, stats,
                                                             dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses = AverageMeter("Loss", ":.4e")
    speed = Throughput()
    t0 = time.perf_counter()
    for i in range(args.steps):
        images, labels = synthetic_batch(i, args.batch_size, args.image_size,
                                         args.num_classes, dev)
        master, stats, opt_state, scaler_state, loss = step(
            master, stats, opt_state, scaler_state, images, labels)
        if i == 0:   # the first step carries the warm-up
            sync()
            speed.start()
            t0 = time.perf_counter()
        else:
            speed.tick(args.batch_size)
        if i % args.print_freq == 0 or i == args.steps - 1:
            losses.update(float(loss))
            print(f"step {i:4d}  loss {losses.val:.6f}  "
                  f"speed {speed.per_sec:8.1f} img/s", flush=True)
    sync()
    dt = time.perf_counter() - t0
    n = (args.steps - 1) * args.batch_size
    print(f"FINAL speed {n / max(dt, 1e-9):.1f} img/s  "
          f"step_time {1000 * dt / max(args.steps - 1, 1):.2f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
