"""Host-side text pipeline: vocabulary and batch transform."""

from thunder_tpu_torch.text.transform import BatchTextTransformer, char_tokenizer  # noqa: F401
from thunder_tpu_torch.text.vocab import Vocabulary  # noqa: F401
