"""Host-side text pipeline: vocabulary, tokenizers (sentencepiece-compatible included) and batch transform."""

from thunder_tpu_torch.text.tokenizer import (  # noqa: F401
    BPETokenizer,
    char_tokenizer,
    get_most_frequent_tokens,
    train_sentencepiece_model,
    word_tokenizer,
)
from thunder_tpu_torch.text.transform import BatchTextTransformer  # noqa: F401
from thunder_tpu_torch.text.vocab import Vocabulary  # noqa: F401
