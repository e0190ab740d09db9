# apxlint: fixture
# Known-clean policy module: disjoint lists, every op either wired in
# ops.py or declared UNWIRED.
FP16_FUNCS = frozenset({"matmul"})

FP32_FUNCS = frozenset({"softmax"})

CASTS = frozenset({"add"})

UNWIRED = frozenset({"softmax", "add"})
