"""Transformer building blocks (the functional attention paths, the
paged decode and verify attention and RoPE)."""
from apex_tpu_torch.transformer.functional.flash_attention import (  # noqa: F401
    flash_attention,
)
from apex_tpu_torch.transformer.functional.fused_rope import (  # noqa: F401
    fused_apply_rotary_pos_emb, fused_apply_rotary_pos_emb_bhsd,
    fused_apply_rotary_pos_emb_bshd, fused_apply_rotary_pos_emb_cached,
    rope_cos_sin, rope_frequencies,
)
from apex_tpu_torch.transformer.functional.paged_attention import (  # noqa: F401
    paged_decode_attention, paged_verify_attention,
)
from apex_tpu_torch.transformer.functional.fused_softmax import (  # noqa: F401
    FusedScaleMaskSoftmax, scaled_masked_softmax,
    scaled_upper_triang_masked_softmax,
)
