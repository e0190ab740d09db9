# apxlint: fixture
# The defining side of a cross-module root: nothing here is captured,
# compiled or checkpointed, but ranks.py hands block() to the port's
# tensor_parallel checkpoint, so its host read must raise APX401 here.
import time


def block(x):
    return x * time.time()


def helper(x):
    return x * time.time()
