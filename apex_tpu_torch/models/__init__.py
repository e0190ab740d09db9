"""Model definitions: GPT (inference subset), BERT with its MLM loss, and
ResNet with its cross-entropy loss."""

from apex_tpu_torch.models.resnet import (  # noqa: F401
    apply_resnet,
    cross_entropy_loss,
    init_resnet,
)
