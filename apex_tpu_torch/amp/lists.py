"""O1 op-policy tables (counterpart of ``apex_tpu/amp/lists.py``,
copied as they are): which ops run in the autocast compute dtype, which
are forced to fp32, and which promote their floating arguments to the
widest. The port's own ops and modules consult them through
:func:`apex_tpu_torch.amp.autocast.cast_args`; nothing is patched.

Names are the op identifiers of the package's call sites.
"""

# Products: run in the autocast compute dtype (bf16/fp16).
FP16_FUNCS = frozenset({
    "conv1d", "conv2d", "conv3d", "conv_transpose2d",
    "matmul", "dot", "dot_general", "einsum", "linear", "dense",
    "bmm", "mm", "mv", "addmm", "addbmm", "baddbmm",
    "attention_qk", "attention_av",
})

# Numerically sensitive ops: always compute in fp32.
FP32_FUNCS = frozenset({
    "softmax", "log_softmax", "cross_entropy", "nll_loss", "mse_loss",
    "l1_loss", "smooth_l1_loss", "kl_div", "cosine_similarity",
    "layer_norm", "rms_norm", "batch_norm", "group_norm", "norm",
    "exp", "expm1", "log", "log10", "log2", "log1p", "pow", "erfinv",
    "softplus", "sigmoid_cross_entropy", "cumprod", "prod", "sum", "mean",
    "var", "std", "renorm", "acos", "asin", "cosh", "sinh", "tan",
})

# Dtype-promoting ops: cast all args to the widest participating dtype.
CASTS = frozenset({
    "add", "sub", "mul", "div", "addcmul", "addcdiv",
    "eq", "ne", "lt", "le", "gt", "ge", "equal",
    "cat", "stack", "where", "min", "max",
})


# Ops of the tables above with no cast_args() call site in the package
# yet, kept literal (not derived from the lists above) so a static
# reader sees them; remove an op from this set when it gains a call
# site (tests/test_torch_amp_o1.py holds the set to the call sites).
UNWIRED = frozenset({
    # FP16_FUNCS not yet routed through cast_args
    # (wired: dense, conv2d, matmul, einsum)
    "conv1d", "conv3d", "conv_transpose2d",
    "dot", "dot_general", "linear",
    "bmm", "mm", "mv", "addmm", "addbmm", "baddbmm",
    "attention_qk", "attention_av",
    # FP32_FUNCS
    "softmax", "log_softmax", "cross_entropy", "nll_loss", "mse_loss",
    "l1_loss", "smooth_l1_loss", "kl_div", "cosine_similarity",
    "layer_norm", "rms_norm", "batch_norm", "group_norm", "norm",
    "exp", "expm1", "log", "log10", "log2", "log1p", "pow", "erfinv",
    "softplus", "sigmoid_cross_entropy", "cumprod", "prod", "sum", "mean",
    "var", "std", "renorm", "acos", "asin", "cosh", "sinh", "tan",
    # CASTS
    "add", "sub", "mul", "div", "addcmul", "addcdiv",
    "eq", "ne", "lt", "le", "gt", "ge", "equal",
    "cat", "stack", "where", "min", "max",
})


def policy_for(op_name: str) -> str:
    """Return 'fp16' | 'fp32' | 'promote' | 'passthrough' for an op name."""
    if op_name in FP16_FUNCS:
        return "fp16"
    if op_name in FP32_FUNCS:
        return "fp32"
    if op_name in CASTS:
        return "promote"
    return "passthrough"
