"""Host-side text pipeline: vocabulary, tokenizers (sentencepiece-compatible included), batch transform,
preprocessing, n-gram and word-fusion LMs, subtitles."""

from thunder_tpu_torch.text.preprocess import expand_numbers, lower_text, normalize_text  # noqa: F401
from thunder_tpu_torch.text.tokenizer import (  # noqa: F401
    BPETokenizer,
    char_tokenizer,
    get_most_frequent_tokens,
    train_sentencepiece_model,
    word_tokenizer,
)
from thunder_tpu_torch.text.lm import ArpaLM, NGramLM  # noqa: F401
from thunder_tpu_torch.text.transform import BatchTextTransformer  # noqa: F401
from thunder_tpu_torch.text.subtitles import to_srt, to_vtt, word_spans  # noqa: F401
from thunder_tpu_torch.text.vocab import Vocabulary  # noqa: F401
from thunder_tpu_torch.text.word_fusion import WordFusionLM, WordNGramLM  # noqa: F401
