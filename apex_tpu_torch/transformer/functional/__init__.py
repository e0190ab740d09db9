from apex_tpu_torch.transformer.functional.flash_attention import (  # noqa: F401
    flash_attention,
)
