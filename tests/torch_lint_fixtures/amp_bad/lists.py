# apxlint: fixture
# Known-bad policy module: 'matmul' lives in two lists (APX301),
# 'softmax' is listed but neither wired nor declared UNWIRED (APX303),
# and 'linear' is declared UNWIRED while ops.py intercepts it (APX304).
FP16_FUNCS = frozenset({"matmul", "linear"})

FP32_FUNCS = frozenset({"matmul", "softmax"})

CASTS = frozenset({"add"})

UNWIRED = frozenset({"add", "linear"})
