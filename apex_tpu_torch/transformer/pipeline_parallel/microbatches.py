"""Microbatch bookkeeping (counterpart of
``apex_tpu/transformer/pipeline_parallel/microbatches.py``; reference:
``apex/transformer/microbatches.py`` and ``pipeline_parallel/utils.py``):
a module-global calculator created by ``setup_microbatch_calculator``;
``ConstantNumMicroBatches`` and ``RampupBatchsizeNumMicroBatches`` (a
linear global-batch ramp over consumed samples, in
``batch_size_increment`` steps). Plain Python, as in the JAX package.
"""

from typing import List, Optional

from apex_tpu_torch.utils.math import ensure_divisibility


class NumMicroBatchesCalculator:
    num_micro_batches: int
    current_global_batch_size: int

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    def update(self, consumed_samples: int, consistency_check: bool) -> None:
        raise NotImplementedError


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    def __init__(self, global_batch_size: int, micro_batch_size: int,
                 data_parallel_size: int):
        micro_times_dp = micro_batch_size * data_parallel_size
        ensure_divisibility(global_batch_size, micro_times_dp)
        self.num_micro_batches = global_batch_size // micro_times_dp
        self.current_global_batch_size = global_batch_size

    def update(self, consumed_samples, consistency_check):
        pass


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    """Linear ramp: the global batch grows from ``start_batch_size`` by
    ``batch_size_increment`` every ``rampup_samples / ((global - start) /
    increment)`` consumed samples (the reference's formula)."""

    def __init__(self, start_batch_size: int, batch_size_increment: int,
                 ramup_samples: int, global_batch_size: int,
                 micro_batch_size: int, data_parallel_size: int):
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.start_batch_size = start_batch_size
        self.batch_size_increment = batch_size_increment
        self.ramup_samples = ramup_samples
        self.global_batch_size = global_batch_size
        self.micro_batch_times_data_parallel_size = \
            micro_batch_size * data_parallel_size

        diff = global_batch_size - start_batch_size
        ensure_divisibility(diff, batch_size_increment)
        num_increments = diff // batch_size_increment
        self.rampup_samples_per_increment = ramup_samples / num_increments

        self.update(0, False)

    def update(self, consumed_samples: int, consistency_check: bool) -> None:
        if consumed_samples > self.ramup_samples:
            current = self.global_batch_size
        else:
            steps = int(consumed_samples / self.rampup_samples_per_increment)
            current = self.start_batch_size \
                + steps * self.batch_size_increment
            assert current <= self.global_batch_size
        if consistency_check:
            ensure_divisibility(
                current, self.micro_batch_times_data_parallel_size)
        self.current_global_batch_size = current
        self.num_micro_batches = max(
            1, current // self.micro_batch_times_data_parallel_size)


_GLOBAL_NUM_MICROBATCHES_CALCULATOR: Optional[NumMicroBatchesCalculator] = None


def setup_microbatch_calculator(
        rank: int, rampup_batch_size: Optional[List[int]],
        global_batch_size: int, micro_batch_size: int,
        data_parallel_size: int) -> None:
    """ref: ``pipeline_parallel/utils.py :: setup_microbatch_calculator``.
    ``rampup_batch_size`` = [start, increment, samples] or None."""
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    if rampup_batch_size is None:
        _GLOBAL_NUM_MICROBATCHES_CALCULATOR = ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size)
    else:
        start, inc, samples = rampup_batch_size
        _GLOBAL_NUM_MICROBATCHES_CALCULATOR = RampupBatchsizeNumMicroBatches(
            start, inc, samples, global_batch_size, micro_batch_size,
            data_parallel_size)


def get_num_microbatches() -> int:
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get()


def get_current_global_batch_size() -> int:
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get_current_global_batch_size()


def update_num_microbatches(consumed_samples: int,
                            consistency_check: bool = True) -> None:
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR.update(consumed_samples,
                                               consistency_check)


def destroy_num_microbatches_calculator() -> None:
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
