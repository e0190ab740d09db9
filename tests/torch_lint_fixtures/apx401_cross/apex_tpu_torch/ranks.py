# apxlint: fixture
# The rooting side: block() from blocks.py recomputed under the port's
# activation checkpoint (helper() is never rooted and stays clean).
from apex_tpu_torch.blocks import block, helper
from apex_tpu_torch.transformer.tensor_parallel import random as tp_random


def forward(x):
    return tp_random.checkpoint(block, x) + helper(x)
