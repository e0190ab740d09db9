"""The transformer test rig (counterpart of
``apex_tpu/transformer/testing``; reference:
``apex/transformer/testing``).

- the reference's standalone models are the port's own zoo
  (``apex_tpu_torch.models``: BERT and the tensor- and pipeline-ready
  GPT), re-exported here under the names reference-shaped code looks
  for;
- ``arguments`` and ``global_vars`` are the Megatron flag parser and the
  process-global args registry; ``commons`` holds the shared test
  helpers.
"""

from apex_tpu_torch.models.bert import (  # noqa: F401  (standalone_bert)
    BertConfig,
    apply_bert,
    bert_tiny,
    init_bert,
)
from apex_tpu_torch.models.gpt import (  # noqa: F401  (standalone_gpt)
    GPTConfig,
    GPTModel,
    gpt_pipeline_model,
    gpt_tiny,
    init_gpt,
)
from apex_tpu_torch.transformer.testing.arguments import (  # noqa: F401
    parse_args,
)
from apex_tpu_torch.transformer.testing.global_vars import (  # noqa: F401
    get_args,
    set_args,
)
